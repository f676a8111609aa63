"""The plain densify rule (``reference/densify.py``) against the program's
densify event on a toy state: every row the event left is explained, and
a row changed, dropped or added is not."""

import pytest
import torch

from conftest import small_cell
from harness import checks, state, train
from reference import densify

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def event():
    from gftorf_tpu_torch.models.gaussians import (
        AdamState, DensifyHyper, GaussianAux, GaussianModelState,
        GaussianParams, densify_and_prune, sort_layout)

    cell = small_cell("ftorf.train.densify")
    cfg = cell.config
    s = state.make_start_state(cfg, train.start_bounds(cfg, cell.scene), 5,
                               2048, 3100, CPU)
    g = torch.Generator().manual_seed(5)
    aux = dict(s.aux)
    n = s.n
    # Screen gradients about the threshold, moments and a few faint rows.
    aux["denom"] = torch.where(aux["alive"], 4.0, 0.0)
    aux["xyz_grad_accum"] = torch.where(
        aux["alive"], 4.0 * 4e-4 * torch.rand(2048, generator=g), 0.0)
    params = dict(s.params)
    params["opacity"] = params["opacity"].clone()
    params["opacity"][:20] = -6.0
    params["scaling"] = params["scaling"].clone()
    params["scaling"][:n // 2] -= 3.0
    mu = {k: torch.randn(v.shape, generator=g) * 1e-3 for k, v in params.items()}
    nu = {k: torch.rand(v.shape, generator=g) * 1e-6 for k, v in params.items()}
    pre = GaussianModelState(GaussianParams(**params), GaussianAux(**aux),
                             AdamState(GaussianParams(**mu), GaussianParams(**nu),
                                       torch.tensor(3100, dtype=torch.int32)))
    hyper = DensifyHyper(grad_threshold=cfg["densify_grad_threshold"],
                         min_opacity=cfg["min_opacity"])
    post, dropped = densify_and_prune(pre, torch.Generator().manual_seed(9),
                                      hyper, 0.55 * cfg["depth_range"], 10.0)
    assert int(dropped) == 0
    return cfg, checks.model_state(pre), checks.model_state(sort_layout(post))


def _numbers(cfg, pre, post):
    return densify.numbers(pre, post, cfg, 0.55 * cfg["depth_range"], True)


def test_event_is_explained(event):
    cfg, pre, post = event
    clone, split, prune = densify.decisions(pre, cfg, 0.55 * cfg["depth_range"],
                                            True)
    assert int(clone.sum()) and int(split.sum()) and int(prune.sum())
    assert _numbers(cfg, pre, post) == {"densify_alive_diff": 0.0,
                                        "densify_unmatched": 0.0}


@pytest.mark.parametrize("change", ["survivor", "split_scale", "split_far",
                                    "dropped", "moment"])
def test_changed_event_is_not(event, change):
    cfg, pre, post = event
    post = {k: (dict(v) if isinstance(v, dict) else v) for k, v in post.items()}
    alive = post["aux"]["alive"].clone()
    rows = torch.nonzero(alive).flatten()
    p = {k: v.clone() for k, v in post["params"].items()}
    if change == "survivor":
        p["opacity"][rows[0]] += 1e-3
    elif change == "split_scale":
        p["scaling"][rows[-1]] *= 1.01
    elif change == "split_far":
        # The last live rows hold split copies (new rows follow survivors).
        p["xyz"][rows[-1]] += 100.0
    elif change == "dropped":
        alive[rows[3]] = False
    elif change == "moment":
        post["mu"] = dict(post["mu"], opacity=post["mu"]["opacity"] + 1e-4)
    post["params"], post["aux"]["alive"] = p, alive
    got = _numbers(cfg, pre, post)
    assert got["densify_alive_diff"] + got["densify_unmatched"] > 0, got
