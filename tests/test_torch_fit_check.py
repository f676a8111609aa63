"""The Trainer's start-up fit check of the dense backward kernel on the CPU.

``render/kernels/dense.py::check_backward_fits`` is the Hopper counterpart
of the TPU kernel ``gftorf_tpu/render/vmem_check.py::try_compile_bwd``: it
asks the card, through ``gftorf_dense_backward_occupancy``, how many blocks
of each instance of csrc/dense_backward.cu an SM holds, and raises where
the card would refuse a launch. Here there is no card, so:

- the plain occupancy model (``blocks_per_sm_plain``) is held against what
  the H100's own query reported for every instance of the backward
  template, from the device properties and instance attributes that
  ``chip_smoke.py [fit-check]`` printed, and gives 0 where threads, shared
  memory or registers run out;
- the check runs with the card's query stubbed (``_lib_backward`` and
  ``torch.cuda.device``): both ``has_flow`` instances at the Trainer's
  ``dd_possible``, and a RuntimeError for 0 blocks, a CUDA error and a
  32x32 tile;
- the Trainer and ``render_sets.load_trained`` call it once each when
  their device's type is "cuda" (an object whose ``type`` is "cuda" in
  place of the device, with ``resolve_device`` replaced in the modules
  that build them), and not with ``check_vmem_cap`` false.
"""

import contextlib
import os
import types

import pytest
import torch

from gftorf_tpu_torch import render_sets
from gftorf_tpu_torch.config import Config
from gftorf_tpu_torch.data.generate import write_dataset
from gftorf_tpu_torch.render.kernels import dense
from gftorf_tpu_torch.train import loop
from gftorf_tpu_torch.train.export import save_scene_artifacts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# torch.cuda.get_device_properties of the card and each instance's report
# (registers a thread, shared bytes a block, blocks per SM) as
# chip_smoke.py [fit-check] printed them on NVIDIA H100 80GB HBM3,
# 700.00 W.
H100 = types.SimpleNamespace(
    warp_size=32, max_threads_per_block=1024,
    max_threads_per_multi_processor=2048, regs_per_multiprocessor=65536,
    shared_memory_per_block_optin=232448,
    shared_memory_per_multiprocessor=233472)
# (pixels, need_dd, has_flow) -> (registers, shared bytes, blocks per SM)
H100_BACKWARD = {
    (pix, need_dd, has_flow): (registers, 151568, 1)
    for pix in (512, 256)
    for (need_dd, has_flow), registers in {
        (False, True): 111, (False, False): 91,
        (True, True): 120, (True, False): 107}.items()
}
# csrc/dense_forward.cu without dd or distribution, from the same run:
# pixels -> (registers, shared bytes, blocks per SM).
H100_FORWARD = {256: (64, 90128, 2), 512: (64, 90128, 2),
                1024: (64, 122896, 1)}
BWD_SHARED = 151568


@pytest.mark.parametrize("pix, registers, shared, blocks", [
    (k[0], *v) for k, v in sorted(H100_BACKWARD.items())] + [
    (pix, *v) for pix, v in sorted(H100_FORWARD.items())])
def test_plain_model_gives_the_h100s_blocks(pix, registers, shared, blocks):
    assert dense.blocks_per_sm_plain(H100, pix, registers, shared) == blocks


@pytest.mark.parametrize("pix, registers, shared, blocks", [
    # Shared memory: the opt-in maximum fits once (with the 1 KB reserved,
    # exactly the SM's 228 KB); one byte more is refused.
    (512, 64, 232448, 1),
    (512, 64, 232449, 0),
    # Two blocks of shared memory fit where each takes under half the SM.
    (256, 32, 115712, 2),
    (256, 32, 115713, 1),
    # Registers: 128 a thread hold one 512-thread block (the launch
    # bounds' budget); 129 round up past the SM's 65,536; 256 is past the
    # 255 a thread can have.
    (512, 128, BWD_SHARED, 1),
    (512, 129, BWD_SHARED, 0),
    (32, 256, 0, 0),
    # Registers and threads without shared memory: 64 a thread leave two
    # 512-thread blocks, 32 a thread four (the SM's 2,048 threads).
    (512, 64, 0, 2),
    (512, 32, 0, 4),
    (1024, 32, 0, 2),
    # The SM's 32 blocks bound the smallest blocks; a block holds at most
    # 1,024 threads.
    (32, 16, 0, 32),
    (64, 16, 0, 32),
    (2048, 16, 0, 0),
])
def test_plain_model_runs_out(pix, registers, shared, blocks):
    assert dense.blocks_per_sm_plain(H100, pix, registers, shared) == blocks


class FakeQuery:
    """``gftorf_dense_backward_occupancy`` on the H100, from H100_BACKWARD:
    records the instances asked for; ``blocks`` overrides the blocks per
    SM and ``error`` makes it return that CUDA error."""

    def __init__(self, blocks=None, error=0):
        self.blocks, self.error, self.calls = blocks, error, []

    def __call__(self, pix, need_dd, has_flow, info):
        self.calls.append((pix, bool(need_dd), bool(has_flow)))
        if self.error:
            return self.error
        registers, shared, blocks = H100_BACKWARD[(pix, bool(need_dd),
                                                   bool(has_flow))]
        info[0] = blocks if self.blocks is None else self.blocks
        info[1], info[2], info[3] = registers, 0, shared
        return 0


@pytest.fixture
def card(monkeypatch):
    """Install a FakeQuery in place of the built library; returns a
    function that swaps in another."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())

    def install(query):
        lib = types.SimpleNamespace(gftorf_dense_backward_occupancy=query)
        monkeypatch.setattr(dense, "_lib_backward", lambda: lib)
        return query

    return install


def dd_possible(opt) -> bool:
    """The JAX Trainer's gate (gftorf_tpu/train/loop.py:159-161)."""
    return (opt.lambda_dd != 0.0
            and opt.dd_loss_iter_end > opt.dd_loss_iter_start + 1)


@pytest.mark.parametrize("config, over", [
    ("ftorf", {}),
    ("torf", {}),
    ("ftorf", {"lambda_dd": 0.1, "dd_loss_iter_start": 0,
               "dd_loss_iter_end": 3000}),
])
def test_check_queries_both_flow_instances_at_dd_possible(card, config, over):
    cfg = Config.from_json(os.path.join(ROOT, "configs", f"{config}.json"),
                           over)
    dd, t = dd_possible(cfg.opt), cfg.tpu
    assert dd == bool(over)
    query = card(FakeQuery())
    before = dense.check_backward_fits.launches
    fits = dense.check_backward_fits(t.tile_h, t.tile_w, dd,
                                     torch.device("cuda"))
    pix = t.tile_h * t.tile_w
    # The ToF render's gate and the colour render's (never dd), each with
    # and without flow.
    want = [(dd, True), (dd, False)] + ([(False, True), (False, False)]
                                        if dd else [])
    assert query.calls == [(pix, *k) for k in want]
    assert list(fits) == want
    assert all(f["blocks_per_sm"] == 1 and f["shared_bytes"] == BWD_SHARED
               for f in fits.values())
    assert dense.check_backward_fits.launches == before + 1


@pytest.mark.parametrize("tile, stub, needle", [
    ((16, 32), {"blocks": 0}, "fits 0 blocks of 512 threads"),
    ((16, 32), {"error": 2}, "cudaError 2"),
    ((32, 32), {}, "tile_pixels=1024"),
    ((12, 20), {}, "tile_pixels=240"),
])
def test_check_refuses(card, tile, stub, needle):
    query = card(FakeQuery(**stub))
    before = dense.check_backward_fits.launches
    with pytest.raises(RuntimeError, match=needle) as err:
        dense.check_backward_fits(*tile, False, torch.device("cuda"))
    if tile == (16, 32):
        assert "need_dd=False, has_flow=True at 16x32 tiles" in str(err.value)
    else:
        assert query.calls == []
    assert dense.check_backward_fits.launches == before


def test_check_takes_only_a_card():
    with pytest.raises(ValueError, match="CUDA card"):
        dense.check_backward_fits(16, 32, False, torch.device("cpu"))


class FakeCuda(str):
    """A device whose type is "cuda" while torch reads it as the CPU."""

    type = "cuda"


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("scene") / "s")
    write_dataset(src, num_frames=4, width=64, height=48, seed=5, device="cpu")
    return src


def small_cfg(src, model_path="", **over):
    return Config.from_dict(dict(
        source_path=src, model_path=model_path, total_num_views=4,
        tof_image_width=64, tof_image_height=48, color_image_width=64,
        color_image_height=48, depth_range=15.0, num_points=200,
        use_quad=True, dynamic=True, dataset_type="quad", **over))


@pytest.fixture
def on_fake_card(monkeypatch):
    """``resolve_device`` of the Trainer's and load_trained's modules gives
    a FakeCuda; the Trainer's call of the check is recorded (no card)."""
    dev = FakeCuda("cpu")
    for module in (loop, render_sets):
        monkeypatch.setattr(module, "resolve_device", lambda device=None: dev)
    calls = []

    def check(tile_h, tile_w, need_dd, device):
        calls.append((tile_h, tile_w, need_dd, device))
        return {(need_dd, True): {}, (need_dd, False): {}}

    monkeypatch.setattr(dense, "check_backward_fits", check)
    return dev, calls


@pytest.mark.parametrize("over, want", [
    ({}, [(16, 32, False)]),
    ({"lambda_dd": 0.1, "dd_loss_iter_end": 100}, [(16, 32, True)]),
    ({"check_vmem_cap": False}, []),
])
def test_trainer_checks_once_on_cuda(scene_dir, on_fake_card, over, want):
    dev, calls = on_fake_card
    tr = loop.Trainer(small_cfg(scene_dir, **over), startup_artifacts=False)
    assert tr.device is dev
    assert [c[:3] for c in calls] == want
    assert all(c[3] is dev for c in calls)
    assert len(tr.backward_fits) == 2 * len(want)


def test_trainer_on_cpu_does_not_check(scene_dir, monkeypatch):
    calls = []
    monkeypatch.setattr(dense, "check_backward_fits",
                        lambda *a: calls.append(a))
    loop.Trainer(small_cfg(scene_dir), startup_artifacts=False, device="cpu")
    assert calls == []


@pytest.fixture(scope="module")
def trained(scene_dir, tmp_path_factory):
    """A model directory as the train CLI leaves it, at iteration 0."""
    model = str(tmp_path_factory.mktemp("model"))
    cfg = small_cfg(scene_dir, model)
    cfg.save(model)
    save_scene_artifacts(loop.Trainer(cfg, startup_artifacts=False,
                                      device="cpu"), 0)
    return model


def test_load_trained_checks_once_on_cuda(trained, on_fake_card):
    dev, calls = on_fake_card
    tr, _, it = render_sets.load_trained(trained)
    assert it == 0 and tr.device is dev
    assert [c[:3] for c in calls] == [(16, 32, False)]
