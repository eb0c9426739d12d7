"""Physical-layer adversarial attacks, FGM and the reference's PGD (JAX
package `train/attacks.py`): take the gradient of the loss with respect to
an intermediate activation (the transmitted symbols tx or the received
symbols y), normalize it into a perturbation, and run the forward again
with the perturbation injected at the channel.

The normalization follows the reference's loop over a (B, L, C) gradient:
each sample's (L, C) slice is L2-normalized and scaled by epsilon, then the
whole is L2-normalized again.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from deepsc_gan_tpu_torch.parallel.batch import all_sum


def fgm_normalize(grad: torch.Tensor, epsilon: float = 1.0,
                  group=None) -> torch.Tensor:
    """Per-sample L2 normalization x epsilon, then a global L2
    normalization, both norms clamped at 1e-12, in f32. With a dp `group`,
    `grad` is a rank's rows and the global norm is the whole batch's (its
    sum of squares summed over the group).

    Quirk Q7, kept: the global normalization cancels epsilon (the
    per-sample rows eps g_i / |g_i| have global norm eps sqrt(B)), so the
    attack's strength is set by the PNR alone."""
    b = grad.shape[0]
    flat = grad.reshape(b, -1).to(torch.float32)
    per_norm = torch.linalg.vector_norm(flat, dim=1, keepdim=True)
    r = epsilon * flat / torch.clamp(per_norm, min=1e-12)
    if group is None:
        norm = torch.linalg.vector_norm(r)
    else:
        norm = torch.sqrt(all_sum(torch.sum(torch.square(r)), group))
    r = r / torch.clamp(norm, min=1e-12)
    return r.reshape(grad.shape)


def fgm_perturbation(loss_of_intermediate: Callable[[torch.Tensor],
                                                    torch.Tensor],
                     intermediate: torch.Tensor, epsilon: float = 1.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (the FGM-normalized gradient of `loss_of_intermediate` at
    `intermediate`, the loss). Only the intermediate's gradient is formed."""
    x = intermediate.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = loss_of_intermediate(x)
        (grad,) = torch.autograd.grad(loss, x)
    return fgm_normalize(grad, epsilon), loss.detach()


def pgd_bisection(loss_of_perturbation: Callable[[torch.Tensor],
                                                 torch.Tensor],
                  direction: torch.Tensor, clean_loss: torch.Tensor,
                  iters: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's "PGD": `iters` steps of bisection on the attack
    strength eps in [0, 1] along the fixed FGM `direction`, for the
    smallest eps whose attacked loss exceeds `clean_loss`. A loop of fixed
    trip count over device tensors (`torch.where`, no host sync). -> (the
    last midpoint eps, the loss re-evaluated at that eps; the loop's last
    loss belongs to the previous midpoint)."""
    f32 = {"dtype": torch.float32, "device": direction.device}
    lo = torch.tensor(0.0, **f32)
    hi = torch.tensor(1.0, **f32)
    eps = (lo + hi) / 2.0
    for _ in range(iters):
        cur = loss_of_perturbation(eps * direction)
        # below the clean loss: the attack is too weak, raise eps
        weak = cur - clean_loss < 0
        lo = torch.where(weak, eps, lo)
        hi = torch.where(weak, hi, eps)
        eps = (lo + hi) / 2.0
    return eps, loss_of_perturbation(eps * direction)
