"""Per-network train state: learning-rate schedules, adam/adamw, gradient
accumulation and the EMA (``joligen_tpu/models/train_state.py:29-64,
138-188,260-270``).

The JAX package builds these from optax; the port writes them out so that
they keep optax's order of operations and rounding:

- ``Adam`` is ``optax.adam``/``optax.adamw``: ``scale_by_adam`` (moments,
  bias correction at count+1, ``mu_hat / (sqrt(nu_hat) + eps)``), then the
  decoupled weight decay on the old parameters, then ``-lr(count)`` read at
  the pre-increment count. ``tpu_optim_moment_dtype=bfloat16`` stores the
  first moment in bf16 (the update still uses the fp32 moment, as optax's
  ``mu_dtype``; the old bf16 moment decays by b1 rounded to bf16, 0.8984375
  for 0.9, as in the jitted optax step). The update runs as ``torch._foreach_*`` ops, in
  place.
- ``MultiSteps`` is ``optax.MultiSteps``: gradients averaged over
  ``train_iter_size`` micro-steps (Welford mean); the inner optimizer, and so
  the LR schedule, counts real updates only.
- ``apply_updates`` lerps the EMA and counts the step on every micro-step,
  as the JAX ``apply_updates`` does.

Optimizer state is a plain dict (ints and numpy arrays keyed like the
parameters): ``state_dict``/``load_state_dict``, pickled by
``BaseModel.save_networks`` and converted from and to optax's state by
``models/convert.py``.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = np.float32


def make_lr_schedule(opt, base_lr):
    """LR schedules with reference semantics (models/modules/utils.py:115-158),
    epoch-granular over ``opt.steps_per_epoch``: ``step -> lr``, computed in
    float32 as the JAX closures are. ``plateau`` (and any other policy) is a
    constant, as in the JAX package."""
    policy = getattr(opt, "train_lr_policy", "linear")
    n_epochs = getattr(opt, "train_n_epochs", 100)
    n_decay = max(1, getattr(opt, "train_n_epochs_decay", 100))
    spe = max(1, int(getattr(opt, "steps_per_epoch", 1)))
    lr = F32(base_lr)

    if policy == "linear":
        # flat for n_epochs then linear decay to 0 over n_epochs_decay
        def sched(step):
            epoch = F32(step) / F32(spe)
            frac = np.clip((epoch - F32(n_epochs)) / F32(n_decay), F32(0),
                           F32(1))
            return float(lr * (F32(1) - frac))
        return sched
    if policy == "step":
        decay_iters = max(1, getattr(opt, "train_lr_decay_iters", 50))

        def sched(step):
            return float(lr * F32(0.1) ** ((step // spe) // decay_iters))
        return sched
    if policy == "multistep":
        milestones = getattr(opt, "train_lr_steps", []) or []

        def sched(step):
            epoch = F32(step) / F32(spe)
            return float(lr * F32(0.1) ** sum(int(epoch >= F32(s))
                                              for s in milestones))
        return sched
    if policy == "cosine":
        def sched(step):
            epoch = F32(step) / F32(spe)
            return float(lr * F32(0.5) * (F32(1) + np.cos(
                F32(np.pi) * epoch / F32(n_epochs))))
        return sched
    return lambda step: float(lr)


class Adam:
    """``optax.adam`` (``weight_decay`` None) or ``optax.adamw`` over the
    parameters ``params`` (name -> tensor), updated in place by
    ``update(grads)``. ``count`` is the number of updates applied."""

    def __init__(self, params, schedule, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=None, mu_dtype=torch.float32):
        self.names = list(params)
        self.params = [params[n] for n in self.names]
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype
        self.count = 0
        with torch.no_grad():
            self.mu = [torch.zeros_like(p, dtype=mu_dtype)
                       for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, grads):
        b1, b2 = self.b1, self.b2
        # moments: (1 - b) * g**k + b * moment, in fp32. Under jit, optax
        # multiplies a bf16 mu by b1 rounded to bf16 (the weakly typed
        # scalar takes the array's dtype) and keeps the product in fp32
        mu = torch._foreach_mul(grads, 1 - b1)
        if self.mu_dtype == torch.float32:
            old_mu, b1_mu = self.mu, b1
        else:
            old_mu = [m.float() for m in self.mu]
            b1_mu = float(torch.tensor(b1).to(self.mu_dtype))
        torch._foreach_add_(mu, torch._foreach_mul(old_mu, b1_mu))
        nu = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(nu, 1 - b2)
        torch._foreach_add_(nu, torch._foreach_mul(self.nu, b2))
        count_inc = self.count + 1
        # bias corrections in float32, as optax computes decay**count
        bc1 = float(F32(1) - F32(b1) ** count_inc)
        bc2 = float(F32(1) - F32(b2) ** count_inc)
        updates = torch._foreach_div(mu, bc1)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(updates, denom)
        if self.weight_decay:
            torch._foreach_add_(updates, torch._foreach_mul(
                self.params, self.weight_decay))
        torch._foreach_mul_(updates, -self.schedule(self.count))
        torch._foreach_add_(self.params, updates)
        self.mu = (mu if self.mu_dtype == torch.float32
                   else [m.to(self.mu_dtype) for m in mu])
        self.nu = nu
        self.count = count_inc

    def state_dict(self):
        """{"count", "mu", "nu"}: numpy fp32 arrays keyed like the params
        (a bf16 moment is exact in fp32)."""
        return {"count": self.count,
                "mu": _to_numpy(self.names, self.mu),
                "nu": _to_numpy(self.names, self.nu)}

    def load_state_dict(self, state):
        self.count = int(state["count"])
        self.mu = _from_numpy(self.names, state["mu"], self.params,
                              self.mu_dtype)
        self.nu = _from_numpy(self.names, state["nu"], self.params,
                              torch.float32)


class MultiSteps:
    """``optax.MultiSteps(inner, every_k)``: ``update`` averages the
    gradients of ``every_k`` calls and applies ``inner`` on the last one;
    returns whether it did."""

    def __init__(self, inner, every_k):
        self.inner = inner
        self.every_k = int(every_k)
        self.mini_step = 0
        self.gradient_step = 0
        with torch.no_grad():
            self.acc = [torch.zeros_like(p) for p in inner.params]

    @torch.no_grad()
    def update(self, grads):
        # acc + (g - acc) / (n + 1): optax's Welford mean
        diff = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(diff, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, diff)
        if self.mini_step < self.every_k - 1:
            self.mini_step += 1
            return False
        self.inner.update(self.acc)
        self.acc = [torch.zeros_like(a) for a in self.acc]
        self.mini_step = 0
        self.gradient_step += 1
        return True

    def state_dict(self):
        return {"mini_step": self.mini_step,
                "gradient_step": self.gradient_step,
                "acc_grads": _to_numpy(self.inner.names, self.acc),
                "inner": self.inner.state_dict()}

    def load_state_dict(self, state):
        self.mini_step = int(state["mini_step"])
        self.gradient_step = int(state["gradient_step"])
        self.acc = _from_numpy(self.inner.names, state["acc_grads"],
                               self.inner.params, torch.float32)
        self.inner.load_state_dict(state["inner"])


def _to_numpy(names, tensors):
    return {n: t.detach().float().cpu().numpy() for n, t in zip(names, tensors)}


def _from_numpy(names, arrays, like, dtype):
    out = []
    for n, p in zip(names, like):
        a = np.asarray(arrays[n], np.float32)
        if a.shape != tuple(p.shape):
            raise ValueError(f"optimizer state {n}: shape {a.shape}, "
                             f"parameter {tuple(p.shape)}")
        out.append(torch.from_numpy(a).to(device=p.device, dtype=dtype))
    return out


def make_optimizer(opt, lr, params, iter_size=None):
    """adam/adamw factory over ``params`` (name -> tensor) (reference
    train.py:51-62); adam8bit maps to adamw, as in the JAX package. The other
    optimizers of the JAX package (radam, lion, madgrad, muon) raise."""
    name = getattr(opt, "train_optim", "adam")
    if name not in ("adam", "adamw", "adam8bit"):
        raise NotImplementedError(
            f"optimizer {name} is not ported (ROADMAP Queue 1 item 6, "
            "training state, the rest)")
    mu_dtype = (torch.bfloat16
                if getattr(opt, "tpu_optim_moment_dtype", "") == "bfloat16"
                else torch.float32)
    tx = Adam(params, make_lr_schedule(opt, lr),
              b1=getattr(opt, "train_beta1", 0.9),
              b2=getattr(opt, "train_beta2", 0.999),
              eps=getattr(opt, "train_optim_eps", 1e-8),
              weight_decay=(None if name == "adam" else
                            getattr(opt, "train_optim_weight_decay", 0.0)),
              mu_dtype=mu_dtype)
    if iter_size is None:
        iter_size = getattr(opt, "train_iter_size", 1)
    if iter_size and iter_size > 1:
        return MultiSteps(tx, iter_size)
    return tx


class NetState:
    """One network's training state (the JAX ``NetState``): the module
    holding the trained parameters, its EMA copy (or None), the optimizer
    over the module's parameters, and ``step``, the count of micro-steps."""

    def __init__(self, net, ema, tx):
        self.net = net
        self.ema = ema
        self.tx = tx
        self.step = 0
        self.params = [p for _, p in net.named_parameters()]


@torch.no_grad()
def apply_updates(state, grads, ema_beta=0.0):
    """Optimizer update from ``grads`` (aligned with ``state.params``), then
    ema = beta * ema + (1 - beta) * params (base_model.py:1284-1297) and
    step + 1, on every micro-step."""
    state.tx.update(list(grads))
    if state.ema is not None:
        ema = list(state.ema.parameters())
        torch._foreach_mul_(ema, ema_beta)
        torch._foreach_add_(ema, torch._foreach_mul(state.params,
                                                    1.0 - ema_beta))
    state.step += 1
