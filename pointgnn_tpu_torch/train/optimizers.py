"""Optimizers and the learning-rate schedule (counterpart of
:mod:`pointgnn_tpu.train.optimizers`, which uses optax).

{sgd, momentum, rmsprop, adam} with the same defaults, an exponential
decay of the learning rate (staircase by default) read at the number of
updates applied so far, and ``MultiSteps`` gradient averaging.  Each
optimizer runs on ``torch.optim`` and updates the parameter tensors in
place from their ``.grad``:

    state = opt.init(params)      # params: the model's tree of tensors
    loss.backward()
    opt.apply(state, params)

``sgd`` and ``momentum`` are ``torch.optim.SGD`` and ``adam`` is
``torch.optim.Adam`` (the optax rules).  optax's RMSprop differs from
``torch.optim.RMSprop`` (eps inside the square root, momentum after the
learning rate), so :class:`RMSpropOptax` implements optax's rule on
``torch.optim.Optimizer``.
"""

import math
from typing import Optional

import torch

from pointgnn_tpu_torch.nn.mlp import named_leaves

_DEFAULT_KWARGS = {
    "sgd": {},
    "momentum": {"momentum": 0.9},
    "rmsprop": {"momentum": 0.9, "decay": 0.9, "epsilon": 1.0},
    "adam": {},
}


def exponential_decay_lr(initial_lr: float, decay_step: int,
                         decay_factor: float, is_staircase: bool = True):
    """``count -> lr``: ``initial_lr * decay_factor ** (count /
    decay_step)``, the exponent floored when ``is_staircase``."""
    def schedule(count):
        p = count / decay_step
        if is_staircase:
            p = math.floor(p)
        return initial_lr if count <= 0 else initial_lr * decay_factor ** p

    return schedule


def param_leaves(params):
    """The tensors of a parameter tree (dicts and lists), in order."""
    return [t for _, t in named_leaves(params)]


class RMSpropOptax(torch.optim.Optimizer):
    """optax.rmsprop: ``nu = decay * nu + (1 - decay) * g^2``, ``u = -lr
    * g / sqrt(nu + eps)``, then a momentum trace ``t = u + momentum *
    t``; the parameter moves by ``t``."""

    def __init__(self, params, lr, decay=0.9, eps=1e-8, momentum=None):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["nu"] = torch.zeros_like(p)
                    if group["momentum"] is not None:
                        st["trace"] = torch.zeros_like(p)
                g = p.grad
                nu = st["nu"]
                nu.mul_(group["decay"]).add_((1 - group["decay"]) * g * g)
                u = -group["lr"] * (g * torch.rsqrt(nu + group["eps"]))
                if group["momentum"] is not None:
                    u = st["trace"].mul_(group["momentum"]).add_(u)
                p.add_(u)


class Optimizer:
    """One of {sgd, momentum, rmsprop, adam} under a learning rate that
    is a number or a schedule ``count -> lr``."""

    def __init__(self, name: str, learning_rate,
                 optimizer_kwargs: Optional[dict] = None):
        if name not in _DEFAULT_KWARGS:
            raise ValueError("unknown optimizer: %s" % name)
        self.name = name
        self.kwargs = dict(_DEFAULT_KWARGS[name])
        self.kwargs.update(optimizer_kwargs or {})
        self.lr = (learning_rate if callable(learning_rate)
                   else (lambda count, v=learning_rate: v))

    def _torch(self, leaves):
        kw, lr = self.kwargs, self.lr(0)
        if self.name == "sgd":
            return torch.optim.SGD(leaves, lr=lr, **kw)
        if self.name == "momentum":
            return torch.optim.SGD(leaves, lr=lr, momentum=kw["momentum"])
        if self.name == "rmsprop":
            return RMSpropOptax(leaves, lr, decay=kw["decay"],
                                eps=kw["epsilon"], momentum=kw["momentum"])
        return torch.optim.Adam(leaves, lr=lr, **kw)

    def init(self, params) -> dict:
        return {"torch": self._torch(param_leaves(params)), "count": 0}

    def apply(self, state: dict, params=None):
        """One update from the leaves' ``.grad``, at the learning rate of
        the updates applied so far."""
        lr = self.lr(state["count"])
        for group in state["torch"].param_groups:
            group["lr"] = lr
        state["torch"].step()
        state["count"] += 1


class MultiSteps:
    """Averages the gradients of ``every_k`` calls and applies the inner
    optimizer on the last of them (the others leave the parameters
    unchanged), as ``optax.MultiSteps`` does."""

    def __init__(self, inner: Optimizer, every_k: int):
        self.inner = inner
        self.every_k = int(every_k)

    def init(self, params) -> dict:
        leaves = param_leaves(params)
        return {"inner": self.inner.init(params), "mini_step": 0,
                "acc": [torch.zeros_like(t) for t in leaves]}

    def apply(self, state: dict, params):
        leaves = param_leaves(params)
        n = state["mini_step"]
        with torch.no_grad():
            for acc, t in zip(state["acc"], leaves):
                if t.grad is not None:
                    acc.add_((t.grad - acc) / (n + 1))
        if n + 1 < self.every_k:
            state["mini_step"] = n + 1
            return
        for acc, t in zip(state["acc"], leaves):
            t.grad = acc.clone()
            acc.zero_()
        self.inner.apply(state["inner"], params)
        state["mini_step"] = 0


def build_from_train_config(train_config: dict):
    """``(optimizer, lr schedule)`` from a train_config dict; gradient
    accumulation only when ``is_pseudo_batch`` is set with a factor > 1
    (the reference default is off)."""
    lr = exponential_decay_lr(
        train_config["initial_lr"],
        train_config["decay_step"],
        train_config["decay_factor"],
        train_config.get("is_staircase", True),
    )
    opt = Optimizer(train_config["optimizer"], lr,
                    train_config.get("optimizer_kwargs"))
    if (train_config.get("is_pseudo_batch", False)
            and train_config.get("pseudo_batch_factor", 0) > 1):
        opt = MultiSteps(opt, train_config["pseudo_batch_factor"])
    return opt, lr
