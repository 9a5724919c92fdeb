"""Per-network train state: learning-rate schedules, the optimizers (adam,
adamw, radam, lion, madgrad, muon), gradient accumulation and the EMA
(``joligen_tpu/models/train_state.py:29-188,260-270``).

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
- ``RAdam`` is ``optax.radam`` (threshold 5, ``eps_root`` 0): the
  rectified update ``r * mu_hat / (sqrt(nu_hat) + eps)`` once rho_t >= 5,
  the bias-corrected first moment alone before; a bf16 first moment as the
  JAX package's ``_cast_mu``.
- ``Lion`` is ``optax.lion``: ``sign((1 - b1) g + b1 mu)`` (sign(0) = 0),
  plus ``wd * p``, times ``-lr``; then ``mu = (1 - b2) g + b2 mu``.
- ``MADGRAD`` is the JAX package's own ``madgrad`` (``:67-101``): eps 1e-6
  added to the lr, lambda_k = (lr + eps) sqrt(k + 1), the weight decay in
  the gradient, the initial parameters ``x0`` kept, the cube root of v.
- ``Muon`` is ``optax.contrib.muon`` as the JAX ``make_optimizer`` builds it
  (beta = max(b1, 0.9), its Adam at b1, b2, every other setting optax's
  default): Nesterov momentum with bias correction, 5 Newton-Schulz steps
  (3.4445, -4.7750, 2.0315) on the matrix divided by its Frobenius norm +
  1e-8 (transposed while rows > cols), scaled by sqrt(max(1, out / in)),
  then the decoupled weight decay and ``-lr``; every other leaf takes
  ``optax.adamw`` with Nesterov momentum and no weight decay. optax picks
  Muon by the rank of the **flax** leaf (``muon_labels``): a Dense kernel
  of an ``nn.scan`` stack is 3-D there (adam), a stack of biases or norm
  scales is 2-D (Muon, across the stack's blocks), a top-level Dense kernel
  or raw 2-D table is 2-D (Muon, in flax's (in, out) orientation). The
  Newton-Schulz products are fp32 ``torch.matmul`` with TF32 off.
- ``MultiSteps`` is ``optax.MultiSteps``: gradients averaged over
  ``train_iter_size`` micro-steps (Welford mean); the inner optimizer, and so
  the LR schedule, counts real updates only.
- ``apply_updates`` lerps the EMA and counts the step on every micro-step,
  as the JAX ``apply_updates`` does.

Optimizer state is a plain dict (ints and numpy arrays keyed like the
parameters): ``state_dict``/``load_state_dict``, pickled by
``BaseModel.save_networks``; ``models/convert.py`` converts optax's state
of each optimizer to it (``optax_state_to_torch``) and adam's back.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .convert import flax_layout

F32 = np.float32
# optax.contrib.muon's defaults
NS_COEFFS = (3.4445, -4.7750, 2.0315)
NS_STEPS = 5


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


def _first_moment(grads, old, b, dtype):
    """(1 - b) * g + b * old in fp32. Under jit, optax multiplies a bf16
    moment by b rounded to bf16 (the weakly typed scalar takes the array's
    dtype) and keeps the product in fp32."""
    mu = torch._foreach_mul(grads, 1 - b)
    if dtype == torch.float32:
        torch._foreach_add_(mu, torch._foreach_mul(old, b))
    else:
        torch._foreach_add_(mu, torch._foreach_mul(
            [m.float() for m in old], float(torch.tensor(b).to(dtype))))
    return mu


def _nesterov(mu, grads, b, count_inc):
    """optax's Nesterov moment: b * mu / (1 - b^(t+1)) + (1 - b) * g /
    (1 - b^t), the corrections in float32."""
    mu_hat = torch._foreach_div(mu, float(F32(1) - F32(b) ** (count_inc + 1)))
    torch._foreach_mul_(mu_hat, b)
    g_hat = torch._foreach_div(grads, float(F32(1) - F32(b) ** count_inc))
    torch._foreach_mul_(g_hat, 1 - b)
    torch._foreach_add_(mu_hat, g_hat)
    return mu_hat


def _stored(moment, dtype):
    return moment if dtype == torch.float32 else [m.to(dtype) for m in moment]


class Adam:
    """``optax.adam`` (``weight_decay`` None) or ``optax.adamw`` over the
    parameters ``params`` (name -> tensor), updated in place by
    ``update(grads)``. ``count`` is the number of updates applied.
    ``nesterov``: optax's Nesterov form of the bias-corrected moment."""

    def __init__(self, params, schedule, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=None, mu_dtype=torch.float32, nesterov=False):
        self.names = list(params)
        self.params = [params[n] for n in self.names]
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype
        self.nesterov = nesterov
        self.count = 0
        with torch.no_grad():
            self.mu = [torch.zeros_like(p, dtype=mu_dtype)
                       for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]

    def _moments(self, grads):
        """The new moments (fp32), the bias-corrected first and second
        moments and the incremented count."""
        b1, b2 = self.b1, self.b2
        mu = _first_moment(grads, self.mu, b1, self.mu_dtype)
        nu = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(nu, 1 - b2)
        torch._foreach_add_(nu, torch._foreach_mul(self.nu, b2))
        count_inc = self.count + 1
        # bias corrections in float32, as optax computes decay**count
        if self.nesterov:
            mu_hat = _nesterov(mu, grads, b1, count_inc)
        else:
            mu_hat = torch._foreach_div(
                mu, float(F32(1) - F32(b1) ** count_inc))
        nu_hat = torch._foreach_div(nu, float(F32(1) - F32(b2) ** count_inc))
        return mu, nu, mu_hat, nu_hat, count_inc

    def _finish(self, updates, mu, nu, count_inc):
        """Weight decay, ``-lr``, the parameters and the state."""
        if self.weight_decay:
            torch._foreach_add_(updates, torch._foreach_mul(
                self.params, self.weight_decay))
        torch._foreach_mul_(updates, -self.schedule(self.count))
        torch._foreach_add_(self.params, updates)
        self.mu = _stored(mu, self.mu_dtype)
        self.nu = nu
        self.count = count_inc

    @torch.no_grad()
    def update(self, grads):
        mu, nu, updates, denom, count_inc = self._moments(grads)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(updates, denom)
        self._finish(updates, mu, nu, count_inc)

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


class RAdam(Adam):
    """``optax.radam`` (threshold 5, ``eps_root`` 0) over ``params``; its
    state is Adam's. ``mu_dtype`` bf16: the JAX package's ``_cast_mu``."""

    threshold = 5.0

    def __init__(self, params, schedule, b1=0.9, b2=0.999, eps=1e-8,
                 mu_dtype=torch.float32):
        super().__init__(params, schedule, b1, b2, eps, None, mu_dtype)

    @torch.no_grad()
    def update(self, grads):
        mu, nu, updates, denom, count_inc = self._moments(grads)
        # rho_t in float32 (the Python floats weakly typed), as optax
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        b2t = F32(self.b2) ** count_inc
        ro = F32(ro_inf) - F32(2 * count_inc) * b2t / (F32(1) - b2t)
        if ro >= self.threshold:
            r = np.sqrt((ro - F32(4)) * (ro - F32(2)) * F32(ro_inf)
                        / (F32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
            torch._foreach_mul_(updates, float(r))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            torch._foreach_div_(updates, denom)
        self._finish(updates, mu, nu, count_inc)


class Lion:
    """``optax.lion`` over ``params``: the sign of (1 - b1) g + b1 mu, plus
    the weight decay, times ``-lr``; mu = (1 - b2) g + b2 mu, stored in
    ``mu_dtype``. State {"count", "mu"}."""

    def __init__(self, params, schedule, b1=0.9, b2=0.99, weight_decay=0.0,
                 mu_dtype=torch.float32):
        self.names = list(params)
        self.params = [params[n] for n in self.names]
        self.schedule = schedule
        self.b1, self.b2 = b1, b2
        self.weight_decay = weight_decay
        self.mu_dtype = mu_dtype
        self.count = 0
        with torch.no_grad():
            self.mu = [torch.zeros_like(p, dtype=mu_dtype)
                       for p in self.params]

    @torch.no_grad()
    def update(self, grads):
        updates = _first_moment(grads, self.mu, self.b1, self.mu_dtype)
        torch._foreach_sign_(updates)
        mu = _first_moment(grads, self.mu, self.b2, self.mu_dtype)
        if self.weight_decay:
            torch._foreach_add_(updates, torch._foreach_mul(
                self.params, self.weight_decay))
        torch._foreach_mul_(updates, -self.schedule(self.count))
        torch._foreach_add_(self.params, updates)
        self.mu = _stored(mu, self.mu_dtype)
        self.count += 1

    def state_dict(self):
        return {"count": self.count, "mu": _to_numpy(self.names, self.mu)}

    def load_state_dict(self, state):
        self.count = int(state["count"])
        self.mu = _from_numpy(self.names, state["mu"], self.params,
                              self.mu_dtype)


class MADGRAD:
    """The JAX package's ``madgrad`` over ``params`` (momentum b1). State
    {"count", "s", "v", "x0"} (``count`` is the JAX state's ``k``)."""

    eps = 1e-6

    def __init__(self, params, schedule, momentum=0.9, weight_decay=0.0):
        self.names = list(params)
        self.params = [params[n] for n in self.names]
        self.schedule = schedule
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.count = 0
        with torch.no_grad():
            self.s = [torch.zeros_like(p) for p in self.params]
            self.v = [torch.zeros_like(p) for p in self.params]
            self.x0 = [p.detach().clone() for p in self.params]

    @torch.no_grad()
    def update(self, grads):
        lamb = float((F32(self.schedule(self.count)) + F32(self.eps))
                     * np.sqrt(F32(self.count) + F32(1)))
        if self.weight_decay:
            grads = torch._foreach_add(grads, torch._foreach_mul(
                self.params, self.weight_decay))
        lg = torch._foreach_mul(grads, lamb)
        v = torch._foreach_add(self.v, torch._foreach_mul(lg, grads))
        s = torch._foreach_add(self.s, lg)
        ck = 1.0 - self.momentum
        # z = x0 - s / (cbrt(v) + eps); p + ((1 - ck) p + ck z - p)
        z = torch._foreach_pow(v, 1.0 / 3.0)
        torch._foreach_add_(z, self.eps)
        z = torch._foreach_div(s, z)
        z = torch._foreach_sub(self.x0, z)
        torch._foreach_mul_(z, ck)
        upd = torch._foreach_mul(self.params, 1.0 - ck)
        torch._foreach_add_(upd, z)
        torch._foreach_sub_(upd, self.params)
        torch._foreach_add_(self.params, upd)
        self.s, self.v = s, v
        self.count += 1

    def state_dict(self):
        return {"count": self.count, "s": _to_numpy(self.names, self.s),
                "v": _to_numpy(self.names, self.v),
                "x0": _to_numpy(self.names, self.x0)}

    def load_state_dict(self, state):
        self.count = int(state["count"])
        for k in ("s", "v", "x0"):
            setattr(self, k, _from_numpy(self.names, state[k], self.params,
                                         torch.float32))


def muon_labels(names_and_ndims, as_flax=False):
    """optax's Muon partition of a torch parameter list: the flax leaves
    (``convert.flax_layout``), each ``(flax path, [parameter indices],
    stacked, transposed)`` with its label, ``"muon"`` where the flax leaf is
    2-D, else ``"adam"``. ``stacked``: the leaf stacks a scanned stack's
    1-D parameters along a new first axis; ``transposed``: a Dense weight,
    whose flax kernel is its transpose. ``as_flax``: every parameter is
    its own flax leaf, as it is (the LoRA adapters)."""
    leaves = {}
    for i, (name, ndim) in enumerate(names_and_ndims):
        if as_flax:
            path, index, transposed = (name,), None, False
        else:
            path, index, transposed = flax_layout(name, ndim)
        leaf = leaves.setdefault(path, {"idx": [], "ndim": ndim,
                                        "stacked": index is not None,
                                        "transposed": transposed})
        leaf["idx"].append((index or 0, i))
    out = []
    for path, leaf in leaves.items():
        idx = [i for _, i in sorted(leaf["idx"])]
        ndim = leaf["ndim"] + (1 if leaf["stacked"] else 0)
        out.append((path, idx, leaf["stacked"], leaf["transposed"],
                    "muon" if ndim == 2 else "adam"))
    return out


@contextlib.contextmanager
def _full_fp32():
    """fp32 matmuls without TF32 on the card."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])


def newton_schulz(x, steps=NS_STEPS, coeffs=NS_COEFFS, eps=1e-8):
    """optax's ``orthogonalize_via_newton_schulz`` of a fp32 matrix in
    flax's (in, out) orientation."""
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.T
    x = x / (torch.linalg.norm(x) + eps)
    c0, c1, c2 = (float(F32(c)) for c in coeffs)
    for _ in range(steps):
        a = x @ x.T
        b = c1 * a + (c2 * a) @ a
        x = c0 * x + b @ x
    return x.T if transposed else x


class Muon:
    """``optax.contrib.muon`` over ``params`` as the JAX ``make_optimizer``
    builds it (see the module doc); ``labels`` is ``muon_labels``' list.
    The Muon leaves keep their momentum in flax's layout; the others go to
    an ``Adam`` with Nesterov momentum. State {"count", "mu" (the Muon
    leaves' torch parameters), "adam" (Adam's state)}."""

    def __init__(self, params, schedule, labels, beta=0.95, b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=0.0):
        self.names = list(params)
        self.params = [params[n] for n in self.names]
        self.schedule = schedule
        self.beta, self.eps, self.weight_decay = beta, eps, weight_decay
        self.leaves = [leaf for leaf in labels if leaf[4] == "muon"]
        self.muon_idx = [i for leaf in self.leaves for i in leaf[1]]
        rest = sorted(set(range(len(self.names))) - set(self.muon_idx))
        self.adam_idx = rest
        self.adam = Adam({self.names[i]: self.params[i] for i in rest},
                         schedule, b1=b1, b2=b2, eps=eps, weight_decay=0.0,
                         nesterov=True)
        self.count = 0
        with torch.no_grad():
            self.mu = [torch.zeros_like(self._flax(leaf, self.params))
                       for leaf in self.leaves]

    @staticmethod
    def _flax(leaf, tensors):
        """A leaf's flax-layout matrix from its parameters (or updates)."""
        _, idx, stacked, transposed, _ = leaf
        if stacked:
            return torch.stack([tensors[i] for i in idx])
        return tensors[idx[0]].T if transposed else tensors[idx[0]]

    @staticmethod
    def _torch(leaf, x):
        """The inverse of ``_flax``: [(parameter index, tensor)]."""
        _, idx, stacked, transposed, _ = leaf
        if stacked:
            return list(zip(idx, x.unbind(0)))
        return [(idx[0], x.T if transposed else x)]

    @torch.no_grad()
    def update(self, grads):
        if self.adam_idx:
            self.adam.update([grads[i] for i in self.adam_idx])
        if not self.leaves:
            self.count += 1
            return
        beta = self.beta
        g = [self._flax(leaf, grads) for leaf in self.leaves]
        mu = _first_moment(g, self.mu, beta, torch.float32)
        count_inc = self.count + 1
        mu_hat = _nesterov(mu, g, beta, count_inc)
        lr = -self.schedule(self.count)
        with _full_fp32():
            for leaf, m in zip(self.leaves, mu_hat):
                u = newton_schulz(m, eps=self.eps)
                scale = np.sqrt(F32(max(1.0, m.shape[1] / m.shape[0])))
                u = u * float(scale)
                for i, ui in self._torch(leaf, u):
                    p = self.params[i]
                    if self.weight_decay:
                        ui = ui + self.weight_decay * p
                    p.add_(ui * lr)
        self.mu = mu
        self.count = count_inc

    def state_dict(self):
        mu = {}
        for leaf, m in zip(self.leaves, self.mu):
            for i, t in self._torch(leaf, m):
                mu[self.names[i]] = t.detach().float().cpu().numpy()
        return {"count": self.count, "mu": mu,
                "adam": self.adam.state_dict()}

    def load_state_dict(self, state):
        self.count = int(state["count"])
        by_index = dict(zip(self.names, range(len(self.names))))
        mu = [None] * len(self.names)
        for name, a in state["mu"].items():
            i = by_index[name]
            mu[i] = torch.from_numpy(np.asarray(a, np.float32)).to(
                self.params[i].device)
        self.mu = [self._flax(leaf, mu) for leaf in self.leaves]
        self.adam.load_state_dict(state["adam"])


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


def make_optimizer(opt, lr, params, iter_size=None, as_flax=False):
    """The optimizer factory over ``params`` (name -> tensor) (reference
    train.py:51-62; ``joligen_tpu/models/train_state.py:138-188``): adam,
    adamw (and adam8bit, as adamw, as in the JAX package), radam, lion,
    madgrad and muon, in ``MultiSteps`` when ``train_iter_size`` > 1.
    ``tpu_optim_moment_dtype=bfloat16`` stores adam's, adamw's, radam's and
    lion's first moment in bf16; madgrad and muon ignore it. ``as_flax``:
    the parameters are their own flax leaves (Muon's labels)."""
    name = getattr(opt, "train_optim", "adam")
    b1 = getattr(opt, "train_beta1", 0.9)
    b2 = getattr(opt, "train_beta2", 0.999)
    eps = getattr(opt, "train_optim_eps", 1e-8)
    wd = getattr(opt, "train_optim_weight_decay", 0.0)
    mu_dtype = (torch.bfloat16
                if getattr(opt, "tpu_optim_moment_dtype", "") == "bfloat16"
                else torch.float32)
    sched = make_lr_schedule(opt, lr)
    if name in ("adam", "adamw", "adam8bit"):
        tx = Adam(params, sched, b1=b1, b2=b2, eps=eps,
                  weight_decay=None if name == "adam" else wd,
                  mu_dtype=mu_dtype)
    elif name == "radam":
        tx = RAdam(params, sched, b1=b1, b2=b2, eps=eps, mu_dtype=mu_dtype)
    elif name == "lion":
        tx = Lion(params, sched, b1=b1, b2=b2, weight_decay=wd,
                  mu_dtype=mu_dtype)
    elif name == "madgrad":
        tx = MADGRAD(params, sched, momentum=b1, weight_decay=wd)
    elif name == "muon":
        labels = muon_labels([(n, p.dim()) for n, p in params.items()],
                             as_flax)
        tx = Muon(params, sched, labels, beta=max(b1, 0.9), b1=b1, b2=b2,
                  weight_decay=wd)
    else:
        raise NotImplementedError(f"optimizer {name}")
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


def param_grads(loss, params):
    """The gradient of ``loss`` for each of ``params``; a parameter the loss
    does not reach (a frozen trunk, a detached table) gets zeros, as in
    JAX."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, params)]


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


def apply_init_scheme(module, generator, init_type, init_gain=0.02):
    """Re-draw every conv and dense kernel (a ``weight`` of rank >= 2) with
    the pix2pix-lineage scheme and zero every bias
    (``joligen_tpu/models/train_state.py:208-249``): ``normal`` N(0, gain),
    ``xavier`` N(0, gain·sqrt(2 / (fan_in + fan_out))), ``kaiming``
    N(0, sqrt(2 / fan_in)) or ``orthogonal`` (scaled by gain); fans count
    the receptive field, as torch's do. Norm scales stay as they are.
    ``generator`` is a CPU generator: the values are drawn on the CPU, so
    they do not depend on the module's device. The JAX package draws from
    its own keys, so the two inits agree in law, not in value."""
    if not init_type or init_type == "default":
        return module
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "bias":
                p.zero_()
                continue
            if leaf != "weight" or p.ndim < 2:
                continue
            receptive = p[0, 0].numel() if p.ndim > 2 else 1
            fan_in, fan_out = p.shape[1] * receptive, p.shape[0] * receptive
            t = torch.empty(p.shape, dtype=torch.float32)
            if init_type == "orthogonal":
                torch.nn.init.orthogonal_(t, init_gain, generator=generator)
            else:
                std = {"normal": init_gain,
                       "xavier": init_gain * np.sqrt(2.0 / (fan_in + fan_out)),
                       "kaiming": np.sqrt(2.0 / fan_in)}.get(init_type)
                if std is None:
                    raise NotImplementedError(
                        f"initialization method [{init_type}] is not "
                        "implemented")
                t.normal_(0.0, float(std), generator=generator)
            p.copy_(t)
    return module


def scheme_from_opt(module, generator, opt):
    """``apply_init_scheme`` from ``model_init_type`` / ``model_init_gain``
    (the GAN models' rule, ``train_state.py:252-260``)."""
    return apply_init_scheme(
        module, generator,
        getattr(opt, "model_init_type", "normal") or "normal",
        float(getattr(opt, "model_init_gain", 0.02) or 0.02))
