"""AdamW with a global-norm clip, and the cosine LR schedule.  The port of
``repro.train.optimizer``.

The arithmetic and its order are the reference's: the f32 global norm
sums the leaves' squared sums in JAX's flatten order (sorted keys), then
come the clip scale, the bias corrections ``b ** (step + 1)`` and
``p32 - lr * (mh / (sqrt(vh) + eps) + wd * p32)``, cast back to the
leaf's dtype.  The update is functional: it returns new trees.
"""
from __future__ import annotations

import math

import torch

from ..tree import leaves, tree_map, unflatten_like


def zeros_like_tree(params):
    return tree_map(torch.zeros_like, params)


@torch.no_grad()
def global_norm(grads):
    """The f32 norm of all leaves, summed in JAX's flatten order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(grads)))


@torch.no_grad()
def adamw_update(params, grads, m, v, step, lr=3e-4, b1=0.9, b2=0.95,
                 eps=1e-8, wd=0.01, clip=1.0, gnorm=None):
    """(new params, new m, new v).  ``step``: the 0-d int32 step tensor
    before this update; ``gnorm``: ``global_norm(grads)`` where the caller
    has it already (computed here otherwise)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp_max(clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    stepf = (step + 1).float()
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf

    def upd(p, g, mm, vv):
        g = g.float() * scale
        mm = b1 * mm + (1 - b1) * g
        vv = b2 * vv + (1 - b2) * g * g
        mh = mm / bc1
        vh = vv / bc2
        p32 = p.float()
        p32 = p32 - lr * (mh / (torch.sqrt(vh) + eps) + wd * p32)
        return p32.to(p.dtype), mm, vv

    out = [upd(p, g, mm, vv) for p, g, mm, vv in
           zip(leaves(params), leaves(grads), leaves(m), leaves(v))]
    return tuple(unflatten_like(params, [o[i] for o in out]) for i in range(3))


def init_train_state(params):
    """The TrainState: ``params``, AdamW's ``m`` and ``v`` (zeros of each
    leaf's dtype) and ``step``, a 0-d int32 tensor on the params' device."""
    dev = leaves(params)[0].device
    return {"params": params, "m": zeros_like_tree(params),
            "v": zeros_like_tree(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def cosine_lr(step, base=3e-4, warmup=100, total=10000, floor=0.1):
    """Linear warmup, then a cosine decay to ``floor * base``; f32, as the
    reference's (a Python int ``step`` is computed as it computes one)."""
    f32 = torch.float32
    warm = base * (step + 1) / warmup
    prog = torch.clamp(torch.as_tensor((step - warmup) / max(total - warmup, 1),
                                       dtype=f32), 0.0, 1.0)
    cos = base * (floor + (1 - floor) * 0.5
                  * (1 + torch.cos(torch.tensor(math.pi, dtype=f32) * prog)))
    return torch.where(torch.as_tensor(step < warmup),
                       torch.as_tensor(warm, dtype=f32), cos)
