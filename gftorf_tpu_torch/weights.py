"""Carry parameters and training state across from the JAX package.

The JAX package's ``GaussianParams``, ``GaussianAux``, ``AdamState``s and
``DeformParams``, given as numpy arrays (``np.asarray`` of each leaf),
become the port's, and each ``..._to_numpy`` turns the port's back into
the JAX layout. The tests use these to feed both packages the same state
and to compare states leaf by leaf; a user can use them to serve or to
resume a model that lives in memory in the JAX package's layout.

Layouts: a Gaussian leaf set is a mapping from field name to array; a
deform leaf set is the JAX ``DeformParams`` order ``(hidden_w, hidden_b,
head_w, head_b)``, hidden weights (in, W) per layer and head weights
(W, out) by head name. The port keeps ``nn.Linear``'s (out, in).
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from gftorf_tpu_torch.models.deform import (
    HEADS,
    DeformConfig,
    DeformNetwork,
    DeformParams,
    deform_params,
)
from gftorf_tpu_torch.models.gaussians import (
    AdamState,
    GaussianAux,
    GaussianModelState,
    GaussianParams,
)
from gftorf_tpu_torch.utils.runtime import resolve_device

# (hidden_w, hidden_b, head_w, head_b), the JAX DeformParams leaves.
DeformLeaves = Tuple[Sequence[np.ndarray], Sequence[np.ndarray],
                     Dict[str, np.ndarray], Dict[str, np.ndarray]]


def _tensor(x, dtype, dev):
    return torch.as_tensor(np.asarray(x, dtype), device=dev)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def gaussian_params_from_numpy(arrays: Mapping[str, np.ndarray],
                               device=None) -> GaussianParams:
    """GaussianParams from a dict of its fields' arrays (float32).
    ``device=None`` means the CUDA card."""
    dev = resolve_device(device)
    return GaussianParams(**{
        name: _tensor(arrays[name], np.float32, dev)
        for name in GaussianParams._fields
    })


def gaussian_params_to_numpy(params) -> Dict[str, np.ndarray]:
    return {k: _numpy(v) for k, v in params._asdict().items()}


def gaussian_aux_from_numpy(arrays: Mapping[str, np.ndarray],
                            device=None) -> GaussianAux:
    dev = resolve_device(device)
    return GaussianAux(
        alive=_tensor(arrays["alive"], bool, dev),
        **{k: _tensor(arrays[k], np.float32, dev)
           for k in ("max_radii2d", "xyz_grad_accum", "denom")},
    )


def gaussian_aux_to_numpy(aux: GaussianAux) -> Dict[str, np.ndarray]:
    return {k: _numpy(v) for k, v in aux._asdict().items()}


def gaussian_adam_from_numpy(mu: Mapping[str, np.ndarray],
                             nu: Mapping[str, np.ndarray], step: int,
                             device=None) -> AdamState:
    dev = resolve_device(device)
    return AdamState(mu=gaussian_params_from_numpy(mu, dev),
                     nu=gaussian_params_from_numpy(nu, dev),
                     step=torch.tensor(int(step), dtype=torch.int32, device=dev))


def gaussian_adam_to_numpy(adam: AdamState):
    """(mu, nu, step) with mu and nu as field -> array dicts."""
    return (gaussian_params_to_numpy(adam.mu),
            gaussian_params_to_numpy(adam.nu), int(adam.step))


def deform_params_from_numpy(hidden_w: Sequence[np.ndarray],
                             hidden_b: Sequence[np.ndarray],
                             head_w: Dict[str, np.ndarray],
                             head_b: Dict[str, np.ndarray],
                             config: DeformConfig,
                             device=None) -> DeformNetwork:
    """DeformNetwork from the JAX ``DeformParams`` leaves: hidden weights
    (in, W) and biases per layer, head weights (W, out) and biases by head
    name. ``config`` gives the embedding widths the arrays cannot tell."""
    dev = resolve_device(device)
    net = DeformNetwork(config)
    if len(hidden_w) != config.depth or len(hidden_b) != config.depth:
        raise ValueError(f"{len(hidden_w)} hidden layers given, config has "
                         f"depth {config.depth}")

    def put(layer, w, b):
        w = torch.as_tensor(np.asarray(w, np.float32)).T
        b = torch.as_tensor(np.asarray(b, np.float32))
        if w.shape != layer.weight.shape or b.shape != layer.bias.shape:
            raise ValueError(f"weight {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)} do not fit {layer}")
        layer.weight.copy_(w)
        layer.bias.copy_(b)

    with torch.no_grad():
        for layer, w, b in zip(net.hidden, hidden_w, hidden_b):
            put(layer, w, b)
        for name in HEADS:
            put(net.heads[name], head_w[name], head_b[name])
    return net.to(dev)


def deform_dict_from_numpy(leaves: DeformLeaves, config: DeformConfig,
                           device=None) -> DeformParams:
    """The name -> tensor dict the training step updates (see
    models/deform.py), from JAX ``DeformParams`` leaves."""
    return deform_params(deform_params_from_numpy(*leaves, config, device))


def deform_dict_to_numpy(params: DeformParams) -> DeformLeaves:
    """The JAX ``DeformParams`` leaves of a name -> tensor dict."""
    depth = sum(1 for k in params if k.startswith("hidden.")
                and k.endswith(".weight"))
    return (
        [_numpy(params[f"hidden.{i}.weight"]).T for i in range(depth)],
        [_numpy(params[f"hidden.{i}.bias"]) for i in range(depth)],
        {h: _numpy(params[f"heads.{h}.weight"]).T for h in HEADS},
        {h: _numpy(params[f"heads.{h}.bias"]) for h in HEADS},
    )


def deform_adam_from_numpy(mu: DeformLeaves, nu: DeformLeaves, step: int,
                           config: DeformConfig, device=None) -> AdamState:
    dev = resolve_device(device)
    return AdamState(mu=deform_dict_from_numpy(mu, config, dev),
                     nu=deform_dict_from_numpy(nu, config, dev),
                     step=torch.tensor(int(step), dtype=torch.int32, device=dev))


def deform_adam_to_numpy(adam: AdamState):
    """(mu, nu, step) with mu and nu as JAX ``DeformParams`` leaves."""
    return (deform_dict_to_numpy(adam.mu), deform_dict_to_numpy(adam.nu),
            int(adam.step))


class TrainingState(NamedTuple):
    """Everything ``train_step`` carries from one iteration to the next,
    and the iteration it last completed."""

    model: GaussianModelState
    deform: DeformParams
    deform_adam: AdamState
    iteration: int


def training_state_from_numpy(params, aux, adam, deform, deform_adam,
                              iteration: int, config: DeformConfig,
                              device=None) -> TrainingState:
    """``params`` and ``aux`` are field -> array mappings, ``adam`` is
    (mu, nu, step) of such mappings, ``deform`` the JAX ``DeformParams``
    leaves and ``deform_adam`` (mu, nu, step) of such leaves."""
    dev = resolve_device(device)
    model = GaussianModelState(
        params=gaussian_params_from_numpy(params, dev),
        aux=gaussian_aux_from_numpy(aux, dev),
        adam=gaussian_adam_from_numpy(*adam, device=dev),
    )
    return TrainingState(
        model=model,
        deform=deform_dict_from_numpy(deform, config, dev),
        deform_adam=deform_adam_from_numpy(*deform_adam, config, dev),
        iteration=int(iteration),
    )


def training_state_to_numpy(state: TrainingState) -> dict:
    """The inverse of ``training_state_from_numpy``, as a dict of its
    arguments."""
    model = state.model
    return dict(
        params=gaussian_params_to_numpy(model.params),
        aux=gaussian_aux_to_numpy(model.aux),
        adam=gaussian_adam_to_numpy(model.adam),
        deform=deform_dict_to_numpy(state.deform),
        deform_adam=deform_adam_to_numpy(state.deform_adam),
        iteration=state.iteration,
    )
