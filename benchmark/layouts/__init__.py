"""Scene layouts: one module a layout, found by the name that a config
file gives under ``"layout"`` (``tof`` where it gives none).

A layout supplies what differs between kinds of capture:

- ``write(out_dir, **scene)``: writes the scene from the parameters of
  the config file's ``scene``;
- ``start_state(cfg, scene, seed, capacity, step, device)``: the start
  state (``harness.state.StartState``) made from ``seed``;
- ``start_meta(cfg, start)``: the Trainer's host state at iteration
  ``start``, written into the start checkpoint;
- ``reference()``: the plain driver the harness calls once the window has
  closed (``read_scene``, ``start``, ``follow``, ``densify_numbers``,
  ``render``; see ``reference/driver.py``). It imports nothing of the
  program and nothing of JAX.
"""
