"""Per-frame deformation MLP for dynamic (F-ToRF) scenes.

Port of ``gftorf_tpu/models/deform.py`` (the reference's DeformNetwork,
utils/time_utils.py:56-127): positional-encoded (xyz, t) -> D x W ReLU
MLP with a skip connection after layer D/2 -> heads for d_xyz, d_rot and
per-channel SH deltas. ``DeformNetwork.forward`` is the counterpart of
``apply_deform``: like the reference it zeroes d_rot and the (phase, amp)
SH deltas at the output, so only the xyz and r/g/b heads are evaluated.
The MLP runs in fp32 (the JAX package's ``deform_precision`` is a TPU
MXU knob with no meaning here).

Training updates the MLP without mutating anyone's module: its parameters
travel as a plain dict of tensors (``DeformParams``, keyed by
``DeformNetwork.named_parameters()``: ``hidden.{i}.weight``,
``heads.{name}.bias``, ...), and ``apply_deform`` is the functional
forward over such a dict. ``DeformNetwork.forward`` is ``apply_deform`` over
the module's own parameters, so the two cannot drift apart.

Weight layout: ``nn.Linear`` keeps (out, in); the JAX package keeps
(in, out). ``weights.deform_params_from_numpy`` transposes.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

HEADS = ("xyz", "rot", "r", "g", "b", "a")


class DeformConfig(NamedTuple):
    depth: int = 8
    width: int = 256
    xyz_multires: int = 10
    t_multires: int = 10
    sh_degree: int = 3
    xavier_init_dxyz: bool = False
    # Isotropic Gaussians (one scale): the step then gives rotations no
    # learning rate, as the JAX package's DeformConfig.isotropic does.
    isotropic: bool = False

    @property
    def skip(self):
        return self.depth // 2

    @property
    def xyz_in(self):
        return 3 + 3 * 2 * self.xyz_multires

    @property
    def t_in(self):
        return 1 + 2 * self.t_multires

    @property
    def num_shs(self):
        return (1 + self.sh_degree) ** 2

    def head_outputs(self, name: str) -> int:
        return {"xyz": 3, "rot": 4}.get(name, self.num_shs)

    def hidden_inputs(self, i: int) -> int:
        """Input width of hidden layer i: layer skip+1 also takes the
        embedded input again."""
        in_dim = self.xyz_in + self.t_in
        if i == 0:
            return in_dim
        return self.width + in_dim if i == self.skip + 1 else self.width


def _embed(x: torch.Tensor, multires: int) -> torch.Tensor:
    """NeRF positional encoding: [x, sin(2^k x), cos(2^k x)] for k<multires
    (time_utils.py:8-53, include_input=True, log sampling)."""
    outs = [x]
    for k in range(multires):
        f = 2.0**k
        outs.append(torch.sin(x * f))
        outs.append(torch.cos(x * f))
    return torch.cat(outs, dim=-1)


def embed_xyz(config: DeformConfig, xyz: torch.Tensor) -> torch.Tensor:
    """Positional embedding of xyz, computed once when the MLP is
    evaluated at several times for the same points."""
    return _embed(xyz, config.xyz_multires)


DeformParams = Dict[str, torch.Tensor]


def apply_deform(params: DeformParams, config: DeformConfig,
                 xyz: torch.Tensor, t: torch.Tensor,
                 x_emb: Optional[torch.Tensor] = None):
    """Deformation at normalized positions (N, 3) and times (N, 1).

    Returns d_xyz (N, 3), d_rot (N, 4) zeros, d_sh (N, M, 3),
    d_sh_p (N, M, 2) zeros — matching time_utils.py:116-127.
    """
    if x_emb is None:
        x_emb = embed_xyz(config, xyz)
    t_emb = _embed(t, config.t_multires)
    h = torch.cat([x_emb, t_emb], dim=-1)
    for i in range(config.depth):
        h = torch.relu(F.linear(h, params[f"hidden.{i}.weight"],
                                params[f"hidden.{i}.bias"]))
        # the concat feeds layer skip+1; when skip is the last layer
        # there is no consumer and the heads take plain width
        if i == config.skip and i + 1 < config.depth:
            h = torch.cat([x_emb, t_emb, h], dim=-1)

    def head(name):
        return F.linear(h, params[f"heads.{name}.weight"],
                        params[f"heads.{name}.bias"])

    d_xyz = head("xyz")
    d_sh = torch.stack([head(c) for c in ("r", "g", "b")], dim=-1)
    n = xyz.shape[0]
    d_rot = d_xyz.new_zeros((n, 4))
    d_sh_p = d_xyz.new_zeros((n, config.num_shs, 2))
    return d_xyz, d_rot, d_sh, d_sh_p


def deform_params(net: "DeformNetwork") -> DeformParams:
    """The module's parameters as a detached name -> tensor dict."""
    return {k: v.detach() for k, v in net.named_parameters()}


def clip_by_global_norm(tree: DeformParams, max_norm: float) -> DeformParams:
    """torch.nn.utils.clip_grad_norm_ semantics (train.py:468), returning
    new tensors instead of scaling in place."""
    norm = torch.sqrt(sum((leaf ** 2).sum() for leaf in tree.values()))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return {k: leaf * scale for k, leaf in tree.items()}


class DeformNetwork(nn.Module):
    """The deformation MLP (``init_deform`` / ``apply_deform`` of the JAX
    package as a module, for serving and loading)."""

    def __init__(self, config: DeformConfig = DeformConfig()):
        super().__init__()
        self.config = config
        self.hidden = nn.ModuleList(
            nn.Linear(config.hidden_inputs(i), config.width)
            for i in range(config.depth)
        )
        self.heads = nn.ModuleDict(
            {name: nn.Linear(config.width, config.head_outputs(name))
             for name in HEADS}
        )

    def forward(self, xyz: torch.Tensor, t: torch.Tensor,
                x_emb: Optional[torch.Tensor] = None):
        """``apply_deform`` over this module's parameters."""
        return apply_deform(dict(self.named_parameters()), self.config, xyz,
                            t, x_emb)


def init_deform(config: DeformConfig = DeformConfig(),
                generator: Optional[torch.Generator] = None,
                device=None) -> DeformNetwork:
    """Random init as the JAX ``init_deform``: xavier-normal hidden
    weights, near-zero (std 1e-5) heads so the network starts as the
    identity deformation, zero biases. Draws from ``generator`` on the
    CPU, then moves to ``device`` (None = the CUDA card)."""
    from gftorf_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)

    def xavier(out_f, in_f):
        std = math.sqrt(2.0 / (in_f + out_f))
        return std * torch.randn((out_f, in_f), generator=generator)

    net = DeformNetwork(config)
    with torch.no_grad():
        for layer in net.hidden:
            layer.weight.copy_(xavier(*layer.weight.shape))
            layer.bias.zero_()
        for name, head in net.heads.items():
            if config.xavier_init_dxyz and name == "xyz":
                head.weight.copy_(xavier(*head.weight.shape))
            else:
                head.weight.copy_(
                    1e-5 * torch.randn(head.weight.shape, generator=generator))
            head.bias.zero_()
    return net.to(dev)
