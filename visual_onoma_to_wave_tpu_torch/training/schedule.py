"""Noam schedule and the acoustic model's optimizer step (port of
visual_onoma_to_wave_tpu/training/schedule.py).

The reference's update is `optax.MultiSteps(chain(clip_by_global_norm,
adam(noam)), k)` when `grad_acc_step` k > 1, else the chain alone.
`NoamAdam` does the same in PyTorch:

  * the k mini-batch gradients are averaged as optax does it (a running
    mean, acc += (g - acc) / (i + 1)); the parameters move only on the
    k-th, and never in between;
  * the averaged gradient is clipped by optax's rule, g / norm * max when
    the global norm exceeds max (not torch's max / (norm + 1e-6));
  * torch's Adam (AdamW when weight_decay > 0) applies it with the
    reference's betas and eps; its update lr * m_hat / (sqrt(v_hat) + eps)
    is optax's;
  * the learning rate is set on the param groups before each Adam step from
    the count of updates applied so far: the schedule sees count + 1
    (`noam_lr`), and under accumulation it counts applied updates, not
    mini-steps, because the reference's schedule lives inside MultiSteps.
"""
from __future__ import annotations

import torch


def noam_lr(count: int, init_lr: float = 0.001, warmup_steps: int = 4000,
            anneal_steps: tuple[int, ...] = (300000, 400000, 500000),
            anneal_rate: float = 0.3) -> float:
    """The learning rate of the update that follows `count` applied updates:
    init_lr * min(s^-0.5, warmup^-1.5 * s) * anneal_rate^(anneals passed),
    s = count + 1 (the reference increments its step before computing)."""
    step = count + 1.0
    scale = min(step ** -0.5, warmup_steps ** -1.5 * step)
    return init_lr * scale * anneal_rate ** sum(step > a for a in anneal_steps)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class NoamAdam:
    """Clip + Adam/AdamW + Noam schedule + gradient accumulation over the
    parameters' `.grad`; `step()` returns whether the parameters moved."""

    def __init__(self, params, init_lr: float = 0.001, warmup_steps: int = 4000,
                 anneal_steps: tuple[int, ...] = (300000, 400000, 500000),
                 anneal_rate: float = 0.3, betas: tuple[float, float] = (0.9, 0.98),
                 eps: float = 1e-9, weight_decay: float = 0.0, grad_clip: float = 1.0,
                 grad_acc_steps: int = 1):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = dict(init_lr=init_lr, warmup_steps=warmup_steps,
                             anneal_steps=tuple(anneal_steps), anneal_rate=anneal_rate)
        self.grad_clip = grad_clip
        self.k = max(1, int(grad_acc_steps))
        if weight_decay > 0:
            self.adam = torch.optim.AdamW(self.params, lr=init_lr, betas=tuple(betas), eps=eps,
                                          weight_decay=weight_decay)
        else:
            self.adam = torch.optim.Adam(self.params, lr=init_lr, betas=tuple(betas), eps=eps)
        self.count = 0        # applied updates (optax's inner count)
        self.mini_step = 0    # mini-batches accumulated since the last update
        self.acc = ([torch.zeros_like(p) for p in self.params] if self.k > 1 else None)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> bool:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.acc is not None:
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.k:
                return False
            self.mini_step = 0
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        norm = global_norm(grads)
        clipped = norm >= self.grad_clip
        for p, g in zip(self.params, grads):
            p.grad = torch.where(clipped, g / norm * self.grad_clip, g)
        lr = noam_lr(self.count, **self.schedule)
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.adam.step()
        self.count += 1
        return True

    # --------------------------------------------------------- checkpoints
    def state_arrays(self, names: list[str]) -> dict:
        """Adam's moments and step, the counts and the accumulation buffers as
        CPU tensors keyed by the parameter names (in `self.params` order)."""
        out = {"count": torch.tensor(self.count), "mini_step": torch.tensor(self.mini_step)}
        for name, p in zip(names, self.params):
            st = self.adam.state.get(p)
            if st:
                out[f"adam_step/{name}"] = torch.as_tensor(st["step"]).detach().cpu()
                out[f"exp_avg/{name}"] = st["exp_avg"].detach().cpu()
                out[f"exp_avg_sq/{name}"] = st["exp_avg_sq"].detach().cpu()
        if self.acc is not None:
            for name, a in zip(names, self.acc):
                out[f"acc/{name}"] = a.detach().cpu()
        return out

    def load_state_arrays(self, names: list[str], arrays: dict) -> None:
        self.count = int(arrays["count"])
        self.mini_step = int(arrays["mini_step"])
        self.adam.state.clear()
        for name, p in zip(names, self.params):
            if f"exp_avg/{name}" in arrays:
                self.adam.state[p] = {
                    "step": torch.as_tensor(arrays[f"adam_step/{name}"], dtype=torch.float32),
                    "exp_avg": torch.as_tensor(arrays[f"exp_avg/{name}"]).to(p.device),
                    "exp_avg_sq": torch.as_tensor(arrays[f"exp_avg_sq/{name}"]).to(p.device)}
        if self.acc is not None:
            for a, name in zip(self.acc, names):
                a.copy_(torch.as_tensor(arrays[f"acc/{name}"]))
