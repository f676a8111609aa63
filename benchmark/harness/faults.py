"""Faults planted under the timed path, to see ``correct`` come out false
and to read the numbers they give: a step that returns its state
unchanged, half of the batch (the image's rows) left out of every loss
with the mean taken over the rest, and an answer altered where it is
produced (every parameter's update 5 % longer; a served frame's depth
0.1 % deeper). Each takes ``patch(obj, name, value)``, which replaces an
attribute of the program (pytest's ``monkeypatch.setattr``, or
``setattr`` in a process of its own)."""

from __future__ import annotations


def unchanged_state(patch):
    from gftorf_tpu_torch.train import loop

    real = loop.train_step

    def step(static, model, deform, deform_adam, *a, **kw):
        packed = real(static, model, deform, deform_adam, *a, **kw)[3]
        return model, deform, deform_adam, packed

    patch(loop, "train_step", step)


def half_batch(patch):
    from gftorf_tpu_torch.train import losses

    def half(fn):
        def loss(pred, gt, *a, **kw):
            h = pred.shape[-2] // 2
            return fn(pred[..., :h, :], gt[..., :h, :], *a, **kw)
        return loss

    for name in ("l1_loss", "l2_loss", "weighted_l1_loss",
                 "weighted_l1_loss_quad", "weighted_l2_loss_quad"):
        patch(losses, name, half(getattr(losses, name)))


def altered_update(patch):
    from gftorf_tpu_torch.models.gaussians import tree_map
    from gftorf_tpu_torch.train import loop

    real = loop.train_step

    def step(static, model, deform, deform_adam, *a, **kw):
        new, new_deform, new_adam, packed = real(static, model, deform,
                                                 deform_adam, *a, **kw)
        params = tree_map(lambda n, o: o + 1.05 * (n - o), new.params,
                          model.params)
        new_deform = {k: deform[k] + 1.05 * (v - deform[k])
                      for k, v in new_deform.items()}
        return new._replace(params=params), new_deform, new_adam, packed

    patch(loop, "train_step", step)


def altered_frame(patch):
    from gftorf_tpu_torch import render_sets

    real = render_sets.render_frame

    def render(*a, **kw):
        static, arrays, rec = real(*a, **kw)
        return static, dict(arrays, depth=arrays["depth"] * 1.001), rec

    patch(render_sets, "render_frame", render)


TRAIN = {"unchanged_state": unchanged_state, "half_batch": half_batch,
         "altered_update": altered_update}
SERVE = {"altered_frame": altered_frame}
