"""The published densify-and-prune rule, held against the rows a
densify event left.

From the state before the event: a live Gaussian whose mean screen
gradient (accumulated over the pixels it reached) is at least the
threshold is cloned where its largest scale is at most ``percent_dense``
of the scene's extent and split in two otherwise; a live Gaussian is
pruned where its opacity is under ``min_opacity`` or, once the size rule
is on, its largest scale is over 0.05 or under 0.001 of the extent; a
split Gaussian is replaced by its two copies. Survivors keep their rows
and Adam moments; a clone copies its source; a split copy copies its
source but for its scales (the source's over 1.6) and its position (the
source's moved by a normal draw in the source's frame and scales, which
is the program's own: only its size is checked); new rows start with
zero moments, and every row's statistics start again at zero.

A row is compared whole: its parameters, moments and statistics, by
their bits (a copy is a copy), so each number here is a count."""

from __future__ import annotations

from typing import Dict

import torch

PARAMS = ("xyz", "sh_color", "sh_phase", "sh_amp", "scaling", "rotation",
          "opacity", "seg_color")
STATS = ("max_radii2d", "xyz_grad_accum", "denom")
# A split copy's normal draw, in its source's frame over its scales, lies
# within this many standard deviations.
DRAW_BOUND = 8.0


def decisions(state: dict, cfg: dict, extent: float, size_rule: bool):
    """The (C,) clone, split and prune masks of the rule."""
    p, aux = state["params"], state["aux"]
    dev = p["xyz"].device
    alive = aux["alive"]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    ext = f32(extent)
    grads = torch.where(aux["denom"] > 0,
                        aux["xyz_grad_accum"] / aux["denom"].clamp(min=1e-30),
                        0.0)
    high = alive & (grads >= f32(cfg["densify_grad_threshold"]))
    largest = torch.exp(p["scaling"]).max(-1).values
    small = largest <= f32(cfg.get("percent_dense", 0.01)) * ext
    prune = alive & (torch.sigmoid(p["opacity"])[:, 0] < f32(cfg["min_opacity"]))
    if size_rule:
        prune = prune | (alive & ((largest > f32(0.05) * ext)
                                  | (largest < f32(0.001) * ext)))
    split = high & ~small
    return high & small, split, prune | split


def _rows(state: dict, keys=PARAMS, moments=True, stats=True) -> torch.Tensor:
    """(C, K) float32 rows: the parameters ``keys``, then both moments of
    those, then the statistics."""
    p = state["params"]
    n = p["xyz"].shape[0]
    cols = [p[k].reshape(n, -1) for k in keys]
    if moments:
        cols += [state["mu"][k].reshape(n, -1) for k in keys]
        cols += [state["nu"][k].reshape(n, -1) for k in keys]
    if stats:
        cols += [state["aux"][k].reshape(n, 1) for k in STATS]
    return torch.cat(cols, 1).float()


def _hash(rows: torch.Tensor) -> torch.Tensor:
    """A 64-bit digest of each row's bits."""
    g = torch.Generator(device="cpu").manual_seed(12345)
    mult = torch.randint(1, 2 ** 62, (rows.shape[1],), generator=g,
                         dtype=torch.int64).to(rows.device) | 1
    bits = rows.contiguous().view(torch.int32).to(torch.int64)
    return (bits * mult).sum(1)


def _missing(a: torch.Tensor, b: torch.Tensor) -> int:
    """Rows of the multiset ``a`` that the multiset ``b`` lacks, plus
    rows of ``b`` that ``a`` lacks."""
    va, ca = torch.unique(a, return_counts=True)
    vb, cb = torch.unique(b, return_counts=True)
    allv = torch.unique(torch.cat([va, vb]))
    na = torch.zeros_like(allv)
    nb = torch.zeros_like(allv)
    na[torch.searchsorted(allv, va)] = ca
    nb[torch.searchsorted(allv, vb)] = cb
    return int((na - nb).abs().sum())


def numbers(pre: dict, post: dict, cfg: dict, extent: float,
            size_rule: bool) -> Dict[str, float]:
    """``densify_alive_diff``: the live rows after the event against the
    rule's count; ``densify_unmatched``: rows that the program's result and
    the rule's disagree on (survivors and clones whole, split copies whole
    but for their positions, and a split copy whose position lies past
    ``DRAW_BOUND`` of its source's scales)."""
    clone, split, prune = decisions(pre, cfg, extent, size_rule)
    alive = pre["aux"]["alive"]
    survive = alive & ~prune
    want = int(survive.sum()) + int(clone.sum()) + 2 * int(split.sum())
    got_alive = post["aux"]["alive"]
    out = {"densify_alive_diff": float(abs(int(got_alive.sum()) - want))}

    zero_stats = dict(pre, aux={k: torch.zeros_like(v) if k in STATS else v
                                for k, v in pre["aux"].items()})
    fresh = dict(zero_stats, mu={k: torch.zeros_like(v) for k, v in pre["mu"].items()},
                 nu={k: torch.zeros_like(v) for k, v in pre["nu"].items()})
    rows_keep = _rows(zero_stats)[survive]
    rows_clone = _rows(fresh)[clone]
    expected_whole = torch.cat([_hash(rows_keep), _hash(rows_clone)])
    got = _rows(post)[got_alive]
    got_h = _hash(got)
    # Program rows that are a survivor or a clone; the rest should be split
    # copies.
    whole_set = torch.unique(expected_whole)
    is_whole = torch.isin(got_h, whole_set)
    unmatched = _missing(got_h[is_whole], expected_whole)

    rest_keys = tuple(k for k in PARAMS if k not in ("xyz", "scaling"))
    src = dict(fresh, params=dict(pre["params"], scaling=torch.log(
        torch.exp(pre["params"]["scaling"]) / 1.6)))
    src_rows = _rows(src, keys=rest_keys + ("scaling",))[split]
    want_split = _hash(src_rows).repeat(2)
    post_idx = torch.nonzero(got_alive).flatten()[~is_whole]
    post_split = _rows(post, keys=rest_keys + ("scaling",))[post_idx]
    unmatched += _missing(_hash(post_split), want_split)

    # Each split copy's draw, from its source matched by its other columns.
    if post_idx.numel() and int(split.sum()):
        src_i = torch.nonzero(split).flatten()
        key_src = _hash(_rows(pre, keys=rest_keys, moments=False, stats=False)[src_i])
        key_got = _hash(_rows(post, keys=rest_keys, moments=False, stats=False)[post_idx])
        order = torch.argsort(key_src)
        at = torch.searchsorted(key_src[order], key_got).clamp(max=src_i.numel() - 1)
        found = key_src[order][at] == key_got
        s = src_i[order][at]
        p = pre["params"]
        q = p["rotation"][s]
        q = q / q.norm(dim=-1, keepdim=True)
        r, x, y, z = q.unbind(-1)
        R = torch.stack([
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1),
            torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1),
            torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1)],
            -2)
        move = post["params"]["xyz"][post_idx] - p["xyz"][s]
        draw = (R.transpose(1, 2) @ move[:, :, None])[:, :, 0] / torch.exp(p["scaling"][s])
        far = ~found | ~torch.isfinite(draw).all(-1) | (draw.abs() > DRAW_BOUND).any(-1)
        unmatched += int(far.sum())
    out["densify_unmatched"] = float(unmatched)
    return out
