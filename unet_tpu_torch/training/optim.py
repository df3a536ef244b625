"""AdamW (port of unet_tpu/training/optim.py).

The JAX package's semantics, which are those of the reference's fused
kernel: bias correction with the 1-based step count, eps outside
sqrt(v_hat), decoupled weight decay on the pre-update parameter,
    p <- p - lr_t * (m_hat / (sqrt(v_hat) + eps) + wd * p),
an optional linear anneal of lr, and float32 moments whatever the type of
the gradients.  These are explicit tensor functions (not
`torch.optim.AdamW`), so that step count, anneal and casts stay the JAX
package's.  Unlike the JAX functions, which return new arrays, they update
the parameters and the moments in place (`torch._foreach_*`): the moments
and the master parameters are the largest state of a step, and a second
copy of each would serve nothing.
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


def _lr_at(step: int, hp: AdamWParams) -> float:
    """Effective lr for the 1-based step `step`."""
    if not hp.anneal_steps:
        return hp.lr
    frac_done = (step - 1.0) / float(hp.anneal_steps)
    return hp.lr * max(0.0, 1.0 - frac_done)


def init_moments(params: Sequence[torch.Tensor]):
    """(m, v): float32 zeros shaped (and laid out) like each parameter."""
    def zeros():
        return [torch.zeros_like(p, dtype=torch.float32) for p in params]
    return zeros(), zeros()


@torch.no_grad()
def adamw_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], m: List[torch.Tensor],
                 v: List[torch.Tensor], step: int, hp: AdamWParams) -> None:
    """One AdamW step over lists of tensors, in place.  `step` is the
    1-based step count (the step being taken); gradients of any floating
    type are taken in float32."""
    bc1 = 1.0 - hp.beta1 ** step
    bc2 = 1.0 - hp.beta2 ** step
    lr = _lr_at(step, hp)
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
        torch._foreach_add_(update, list(params), alpha=hp.weight_decay)
    torch._foreach_add_(list(params), update, alpha=-lr)


def adamw_update_flat(flat: torch.Tensor, g_flat: torch.Tensor,
                      m: torch.Tensor, v: torch.Tensor, step: int,
                      hp: AdamWParams) -> None:
    """`adamw_update` on one flat float32 vector of all parameters (the
    reference's single update over its parameter arena), in place."""
    adamw_update([flat], [g_flat], [m], [v], step, hp)
