"""AdamW (port of unet_tpu/training/optim.py).

The JAX package's semantics, which are those of the reference's fused
kernel: bias correction with the 1-based step count, eps outside
sqrt(v_hat), decoupled weight decay on the pre-update parameter,
    p <- p - lr_t * (m_hat / (sqrt(v_hat) + eps) + wd * p),
an optional linear anneal of lr, and float32 moments whatever the type of
the gradients.  These are explicit tensor functions (not
`torch.optim.AdamW`), so that step count, anneal and casts stay the JAX
package's.  Unlike the JAX functions, which return new arrays, they update
the parameters and the moments in place: the moments and the master
parameters are the largest state of a step, and a second copy of each
would serve nothing.

The step count may be an int or a 0-dim tensor on the parameters' device.
Either way lr_t and the two bias corrections are computed from it on that
device as 0-dim float32 tensors, as the JAX package computes them from the
traced `step_f32`: a captured step (`training/graphs.py`) that advances a
device counter then updates with the step it runs, not the one it was
captured at.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch


class AdamWParams(NamedTuple):
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    # Linear lr anneal over this many steps (0 = constant):
    # lr_t = lr * (1 - completed_steps / anneal), clamped at 0, where
    # completed_steps counts optimizer steps already taken (so step 1 runs
    # at full lr).
    anneal_steps: int = 0


def _lr_at(step_f32: torch.Tensor, hp: AdamWParams) -> torch.Tensor:
    """Effective lr for the 1-based step `step_f32` (0-dim float32)."""
    if not hp.anneal_steps:
        return torch.full_like(step_f32, hp.lr)
    frac_done = (step_f32 - 1.0) / float(hp.anneal_steps)
    return hp.lr * torch.clamp(1.0 - frac_done, min=0.0)


def _scalars(step, hp: AdamWParams, device):
    """(bc1, bc2, lr_t) of the 1-based step `step` (an int or a 0-dim
    tensor), 0-dim float32 tensors on `device`."""
    if torch.is_tensor(step):
        s = step.to(torch.float32)
    else:  # a fill, not a copy from the host, which would wait for the card
        s = torch.full((), float(step), dtype=torch.float32, device=device)
    bc1 = 1.0 - torch.pow(hp.beta1, s)
    bc2 = 1.0 - torch.pow(hp.beta2, s)
    return bc1, bc2, _lr_at(s, hp)


def init_moments(params: Sequence[torch.Tensor]):
    """(m, v): float32 zeros shaped (and laid out) like each parameter."""
    def zeros():
        return [torch.zeros_like(p, dtype=torch.float32) for p in params]
    return zeros(), zeros()


@torch.no_grad()
def adamw_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], m: List[torch.Tensor],
                 v: List[torch.Tensor], step, hp: AdamWParams) -> None:
    """One AdamW step over lists of tensors, in place (`torch._foreach_*`).
    `step` is the 1-based step count (the step being taken); gradients of
    any floating type are taken in float32."""
    params = list(params)
    bc1, bc2, lr = _scalars(step, hp, params[0].device)
    g = [x.float() for x in grads]
    torch._foreach_mul_(m, hp.beta1)
    torch._foreach_add_(m, g, alpha=1.0 - hp.beta1)
    torch._foreach_mul_(v, hp.beta2)
    torch._foreach_addcmul_(v, g, g, value=1.0 - hp.beta2)
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, hp.eps)
    update = torch._foreach_div(m, bc1)
    torch._foreach_div_(update, denom)
    if hp.weight_decay:
        torch._foreach_add_(update, params, alpha=hp.weight_decay)
    torch._foreach_mul_(update, lr)
    torch._foreach_sub_(params, update)


@torch.no_grad()
def adamw_update_flat(flat: torch.Tensor, g_flat: torch.Tensor,
                      m: torch.Tensor, v: torch.Tensor, step,
                      hp: AdamWParams) -> None:
    """AdamW on one flat float32 vector of all parameters (the reference's
    single update over its parameter arena), in place: a handful of
    elementwise launches over the whole vector."""
    bc1, bc2, lr = _scalars(step, hp, flat.device)
    g = g_flat.float()
    m.mul_(hp.beta1).add_(g, alpha=1.0 - hp.beta1)
    v.mul_(hp.beta2).addcmul_(g, g, value=1.0 - hp.beta2)
    update = (m / bc1).div_((v / bc2).sqrt_().add_(hp.eps))
    if hp.weight_decay:
        update.add_(flat, alpha=hp.weight_decay)
    flat.sub_(update.mul_(lr))
