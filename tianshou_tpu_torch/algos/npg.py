"""NPG and TRPO: natural-gradient policy optimisation (port of
``tianshou_tpu/algos/npg.py``).

The actor moves by a natural-gradient step; Adam covers the critic only,
with ``optim_critic_iters`` steps a learn.  The natural direction solves
``F x = g`` by ``cg_iters`` conjugate-gradient iterations, ``F`` the Fisher
matrix (the Hessian of the mean KL from the old policy) plus
``cg_damping``.  A Fisher-vector product is a double backward: the KL's
gradient is built once with ``create_graph=True``, and each product is the
gradient of its dot with the vector.  The actor's parameters are flattened
in ``parameters()`` order, which is not the JAX package's ``ravel_pytree``
order (Flax's sorted keys): compare them unflattened.

TRPO scales the step to the KL limit and evaluates ``max_backtracks``
fractions of it at once (``torch.func.vmap`` over ``functional_call``),
taking the first whose KL is under ``max_kl`` and whose surrogate improves,
through ``argmax`` and ``where``: no branch on a device value, so a learn
makes no host synchronisation.  NPG takes a fixed ``trust_region_size``
step.
"""

from __future__ import annotations

import torch
from torch import nn

from tianshou_tpu_torch.algos.a2c import A2C
from tianshou_tpu_torch.algos.ddpg import apply_loss, fresh_copy
from tianshou_tpu_torch.algos.pg import OnPolicyTrainState
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.tree import tree_map
from tianshou_tpu_torch.envs.spaces import Box, Discrete
from tianshou_tpu_torch.ops.dist import kl_categorical, kl_normal

__all__ = ["NPG", "TRPO"]


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _grads(out: torch.Tensor, params: list[nn.Parameter], **kwargs) -> list[torch.Tensor]:
    """``d out / d params``, zeros for a parameter ``out`` does not reach."""
    grads = torch.autograd.grad(out, params, allow_unused=True, **kwargs)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


class NPG(A2C):
    def __init__(
        self,
        actor: nn.Module,
        critic: nn.Module,
        action_space: Box | Discrete,
        *,
        critic_lr: float = 1e-3,
        gamma: float = 0.99,
        gae_lambda: float = 0.95,
        optim_critic_iters: int = 5,
        trust_region_size: float = 0.5,
        cg_iters: int = 10,
        cg_damping: float = 0.1,
        adv_norm: bool = True,
        ret_norm: bool = True,
        deterministic_eval: bool = True,
        device: str | torch.device = "cuda",
    ):
        super().__init__(
            actor, critic, action_space, lr=critic_lr, gamma=gamma, gae_lambda=gae_lambda, adv_norm=adv_norm,
            ret_norm=ret_norm, deterministic_eval=deterministic_eval, device=device,
        )
        self.optim_critic_iters = optim_critic_iters
        self.trust_region_size = trust_region_size
        self.cg_iters = cg_iters
        self.cg_damping = cg_damping

    def init(self, generator: torch.Generator) -> OnPolicyTrainState:
        actor = fresh_copy(self.actor, self.device, generator)
        critic = fresh_copy(self.critic, self.device, generator)
        return OnPolicyTrainState(actor=actor, critic=critic, optimizer=self._optimizer(list(critic.parameters()), self.lr),
                                  **self._ret_stats(), **self._schedule_state())

    # -- the natural gradient ----------------------------------------------
    def _kl(self, dist_old, dist_new) -> torch.Tensor:
        if self.discrete:
            return kl_categorical(dist_old, dist_new).mean()
        return kl_normal(*dist_old, *dist_new).mean()

    def _surrogate(self, dist_new, mb: Batch, adv: torch.Tensor) -> torch.Tensor:
        """The vanilla policy-gradient objective (TRPO: the ratio's)."""
        logp, _ = self._log_prob_entropy(dist_new, mb["act"])
        return -(logp * adv).mean()

    def _conjugate_gradient(self, fvp, g: torch.Tensor) -> torch.Tensor:
        """``cg_iters`` iterations of CG on ``F x = g`` from ``x = 0``."""
        x, r, p = torch.zeros_like(g), g, g
        rdotr = r @ r
        for _ in range(self.cg_iters):
            fp = fvp(p)
            alpha = rdotr / (p @ fp + 1e-12)
            x = x + alpha * p
            r = r - alpha * fp
            new_rdotr = r @ r
            p = r + new_rdotr / (rdotr + 1e-12) * p
            rdotr = new_rdotr
        return x

    def _natural_gradient(self, ts: OnPolicyTrainState, mb: Batch, adv: torch.Tensor):
        """``(params, flat params, direction, d^T F d, old distribution)``."""
        params = list(ts.actor.parameters())
        dist = ts.actor(mb["obs"])
        dist_old = tree_map(torch.Tensor.detach, dist)
        g = _flat(_grads(self._surrogate(dist, mb, adv), params, retain_graph=True))
        kl_grad = _flat(_grads(self._kl(dist_old, dist), params, create_graph=True))

        def fvp(v: torch.Tensor) -> torch.Tensor:
            return _flat(_grads(kl_grad @ v, params, retain_graph=True)) + self.cg_damping * v

        direction = self._conjugate_gradient(fvp, g)
        d_f_d = direction @ fvp(direction)
        flat0 = _flat([p.detach() for p in params])
        return params, flat0, direction.detach(), d_f_d.detach(), dist_old

    @staticmethod
    @torch.no_grad()
    def _set_flat(params: list[nn.Parameter], flat: torch.Tensor) -> None:
        views = [v.view_as(p) for v, p in zip(flat.split([p.numel() for p in params]), params)]
        torch._foreach_copy_(params, views)

    def _actor_step(self, ts: OnPolicyTrainState, mb: Batch, adv: torch.Tensor) -> dict[str, torch.Tensor]:
        params, flat0, d, _, _ = self._natural_gradient(ts, mb, adv)
        self._set_flat(params, flat0 - self.trust_region_size * d)
        return {}

    # -- learning ----------------------------------------------------------
    def learn(self, ts: OnPolicyTrainState, mb: Batch, generator: torch.Generator | None = None):
        adv = self._normalized_adv(mb)
        extra = self._actor_step(ts, mb, adv)
        vlosses = []
        for _ in range(self.optim_critic_iters):
            vloss = ((mb["ret"] - ts.critic(mb["obs"])) ** 2).mean()
            apply_loss(ts.optimizer, vloss)
            vlosses.append(vloss.detach())
        ts.step += 1
        return ts, {"value_loss": torch.stack(vlosses).mean(), **extra}


class TRPO(NPG):
    """NPG with a backtracking line search under a hard KL limit."""

    def __init__(self, *args, max_kl: float = 0.01, backtrack_coeff: float = 0.8, max_backtracks: int = 10,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.max_kl = max_kl
        self.backtrack_coeff = backtrack_coeff
        self.max_backtracks = max_backtracks

    def _surrogate(self, dist_new, mb, adv):
        logp, _ = self._log_prob_entropy(dist_new, mb["act"])
        return -(torch.exp(logp - mb["logp_old"]) * adv).mean()

    def _actor_step(self, ts, mb, adv):
        params, flat0, d, d_f_d, dist_old = self._natural_gradient(ts, mb, adv)
        # the full step, where the quadratic model of the KL reaches max_kl
        full_step = torch.sqrt(2.0 * self.max_kl / (d_f_d + 1e-12))
        fracs = self.backtrack_coeff ** torch.arange(self.max_backtracks, dtype=flat0.dtype, device=flat0.device)
        names = [n for n, _ in ts.actor.named_parameters()]
        sizes = [p.numel() for p in params]

        def evaluate(flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
            named = {n: v.view_as(p) for n, v, p in zip(names, flat.split(sizes), params)}
            dist = torch.func.functional_call(ts.actor, named, (mb["obs"],))
            return self._surrogate(dist, mb, adv), self._kl(dist_old, dist)

        with torch.no_grad():
            loss0, _ = evaluate(flat0)
            losses, kls = torch.func.vmap(lambda frac: evaluate(flat0 - frac * full_step * d))(fracs)
            ok = (kls < self.max_kl) & (losses < loss0)
            first = torch.argmax(ok.to(torch.int32)).reshape(1)  # the first accepted fraction
            any_ok = ok.any()
            frac = torch.where(any_ok, fracs.gather(0, first)[0], 0.0)
            self._set_flat(params, flat0 - frac * full_step * d)
        return {"accepted": any_ok.to(torch.float32), "kl": kls.gather(0, first)[0]}
