"""Adam (Kingma and Ba, arXiv:1412.6980) with torch's defaults, written out:
``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
``p -= lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``; weight decay
``wd * p`` added to the gradient (``Adam(weight_decay=wd)``)."""
from __future__ import annotations


import torch

__all__ = ["Adam"]


class Adam:
    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, betas[0], betas[1], eps, weight_decay
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            if p.grad is None:
                continue
            g = p.grad + self.wd * p if self.wd else p.grad
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))
            p.grad = None
