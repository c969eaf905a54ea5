"""Plain reference of TopK-SAE training steps under AMP, and the
comparison of a trainer's first steps with it.

A step on rows ``x [B, D]`` (f32), from the published TopK SAE and its
training recipe: centre ``xc = x - b_pre``; ``pre = xc W_enc + b_enc``;
keep ``relu(pre)`` where ``pre`` is among the row's k largest; decode
``recon = hidden W_dec + b_dec + b_pre``; loss ``mean((recon - x)^2)``.
The gradients are the loss's, through the selection as a fixed mask,
written out; products take their operands at the configuration's
compute precision (``lowp``) and sum in f32.  Then global-norm clipping,
AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled decay, update ``t`` at the
rate of the warmup-cosine schedule at ``t``), unit-norm decoder rows,
and the dead-feature counters (the step count; each feature's last
active step).

Late in a long epoch the reference follows the program teacher-forced:
the loss of step ``s`` on the rows the reference orders for it, at the
parameters the program held before that step (``loss_at``).

The trainer orders an epoch's rows by its documented rule:
``torch.randperm(n)`` under a CPU generator seeded from
``SeedSequence([seed, epoch])``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .lowp import ROUNDERS, true_f32

NAMES = ("w_enc", "b_enc", "w_dec", "b_dec", "b_pre")
B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class Recipe:
    k: int
    batch: int
    lr: float
    warmup: int
    total_steps: int
    clip: float
    weight_decay: float
    seed: int  # the trainer's seed: the epochs' orders


def learning_rate(r: Recipe, count: int) -> float:
    """Linear warmup from 1% over ``W = min(warmup, total // 10)`` steps, then
    cosine to a tenth of the rate, evaluated in float32."""
    w = min(r.warmup, r.total_steps // 10)
    t = np.float32(count)
    if count < w:
        return float(np.float32(r.lr) * (np.float32(0.01) + np.float32(0.99) * t / np.float32(w)))
    t_cos = max(r.total_steps - w, 1)
    eta = np.float32(0.1 * r.lr)
    c = np.clip(t - w, 0.0, t_cos)
    return float(eta + (np.float32(r.lr) - eta) * np.float32(0.5)
                 * (np.float32(1.0) + np.cos(np.float32(np.pi) * c / np.float32(t_cos))))


def permutation(n: int, seed: int, epoch: int) -> torch.Tensor:
    mixed = int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0])
    return torch.randperm(n, generator=torch.Generator().manual_seed(mixed))


def _forward(p: dict, x: torch.Tensor, k: int, mm) -> tuple[torch.Tensor, ...]:
    """-> the centred rows, the kept latents and the residual."""
    xc = x - p["b_pre"]
    pre = mm(xc, p["w_enc"]) + p["b_enc"]
    kth = torch.topk(pre, k, dim=1).values[:, -1:]
    hidden = torch.where(pre >= kth, torch.relu(pre), torch.zeros((), device=x.device))
    recon = mm(hidden, p["w_dec"]) + p["b_dec"] + p["b_pre"]
    return xc, hidden, recon - x


def _rows(x: torch.Tensor, half: bool) -> torch.Tensor:
    # a fault: half of the batch left out, the mean over the rest
    return x[:x.shape[0] // 2] if half else x


def _step(p: dict, st: dict, x: torch.Tensor, r: Recipe, rnd, half: bool) -> tuple[float, float]:
    x = _rows(x, half)
    b, d = x.shape
    mm = lambda a, w: torch.matmul(rnd(a), rnd(w))  # noqa: E731
    xc, hidden, resid = _forward(p, x, r.k, mm)
    loss = float((resid.double() ** 2).mean())
    pos = hidden > 0
    l0 = float(pos.sum(dim=1).double().mean())
    d_recon = resid * (2.0 / (b * d))
    dpre = torch.where(pos, mm(d_recon, p["w_dec"].t()), torch.zeros((), device=x.device))
    g = {"w_enc": mm(xc.t(), dpre), "b_enc": dpre.sum(dim=0), "w_dec": mm(hidden.t(), d_recon),
         "b_dec": d_recon.sum(dim=0)}
    g["b_pre"] = g["b_dec"] - torch.matmul(rnd(p["w_enc"]), g["b_enc"])
    norm = math.sqrt(sum(float((v.double() ** 2).sum()) for v in g.values()))
    if norm >= r.clip:
        g = {n: v * (r.clip / norm) for n, v in g.items()}
    lr = learning_rate(r, st["count"])
    st["count"] += 1
    bc1, bc2 = 1.0 - B1 ** st["count"], 1.0 - B2 ** st["count"]
    for n in NAMES:
        st["mu"][n].mul_(B1).add_(g[n] * (1.0 - B1))
        st["nu"][n].mul_(B2).add_(g[n] * g[n] * (1.0 - B2))
        update = (st["mu"][n] / bc1) / (torch.sqrt(st["nu"][n] / bc2) + EPS)
        if r.weight_decay:
            update = update + r.weight_decay * p[n]
        p[n].sub_(lr * update)
    p["w_dec"].div_(torch.linalg.vector_norm(p["w_dec"], dim=1, keepdim=True).clamp(min=1e-12))
    st["step"] += 1
    st["last"] = torch.where(pos.any(dim=0), st["step"], st["last"])
    return loss, l0


@torch.no_grad()
def train(params0: dict, calls: list[torch.Tensor], r: Recipe, precision: str = "bf16",
          half: bool = False) -> dict:
    """Follow the trainer through ``calls``: each an epoch over its rows
    (shuffled by the trainer's rule, epochs counted from 0) in steps of
    ``r.batch``.  -> each step's loss and l0, the first step's gradient as
    AdamW received it (from its first moment), the parameters after the
    last step, and the dead-feature counters."""
    rnd = ROUNDERS[precision]
    p = {n: params0[n].detach().float().clone() for n in NAMES}
    zeros = {n: torch.zeros_like(v) for n, v in p.items()}
    st = {"count": 0, "step": 0, "mu": {n: v.clone() for n, v in zeros.items()},
          "nu": zeros, "last": torch.zeros(p["b_enc"].shape[0], dtype=torch.int64,
                                           device=p["b_enc"].device)}
    out = {"loss": [], "l0": []}
    with true_f32():
        for epoch, rows in enumerate(calls):
            perm = permutation(rows.shape[0], r.seed, epoch).to(rows.device)
            sel = rows[perm]
            for s in range(rows.shape[0] // r.batch):
                loss, l0 = _step(p, st, sel[s * r.batch:(s + 1) * r.batch], r, rnd, half)
                out["loss"].append(loss)
                out["l0"].append(l0)
                if st["count"] == 1:
                    out["grad1"] = {n: v / (1.0 - B1) for n, v in st["mu"].items()}
    out["params"] = p
    out["last_active"] = st["last"]
    out["step_count"] = st["step"]
    return out


@torch.no_grad()
def loss_at(params: dict, x: torch.Tensor, k: int, precision: str = "bf16",
            half: bool = False) -> float:
    """The loss of one step's rows ``x`` at the parameters ``params`` the
    step started from (a teacher-forced step: the program's own state)."""
    rnd = ROUNDERS[precision]
    p = {n: params[n].detach().float() for n in NAMES}
    with true_f32():
        _, _, resid = _forward(p, _rows(x, half), k, lambda a, w: torch.matmul(rnd(a), rnd(w)))
    return float((resid.double() ** 2).mean())


def epoch_rows(rows: torch.Tensor, r: Recipe, epoch: int, steps) -> dict[int, torch.Tensor]:
    """The rows of each of ``steps`` in epoch ``epoch`` over ``rows``, in the
    trainer's documented order."""
    perm = permutation(rows.shape[0], r.seed, epoch).to(rows.device)
    return {s: rows[perm[s * r.batch:(s + 1) * r.batch]] for s in steps}


def late_gap(prog: dict[int, float], ref: dict[int, float]) -> float:
    """``late_loss``: the largest relative gap of a late step's loss,
    both sides at the program's parameters before that step."""
    return max(abs(prog[s] - ref[s]) / abs(ref[s]) for s in ref)


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict[str, float]:
    """Each leaf's gap of norms, ``| |p| - |r| |``, over the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    names = [n for n in NAMES if keep is None or n in keep]
    rn = {n: _norm(ref[n]) for n in names}
    floor = float(np.median(list(rn.values())))
    return {n: abs(_norm(prog[n]) - rn[n]) / max(rn[n], floor) for n in names}


def compare(prog: dict, ref: dict, params0: dict) -> dict[str, float]:
    """The numbers the check compares, program (or control) against the
    reference:

    - ``loss``: the largest relative gap of a step's loss;
    - ``grad1``: the worst leaf's gap of norms of the first gradient;
    - ``delta3``: the worst leaf's gap of norms of the parameters' change
      over the steps, leaving out a leaf whose reference gradient is under
      a thousandth of the median leaf's (nought to rounding, it moves by
      round-off alone);
    - ``dead``: the share of features whose last active step differs, or
      1 where the step counts differ.
    """
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"], strict=True))
    g_norm = {n: _norm(ref["grad1"][n]) for n in NAMES}
    g_floor = 1e-3 * float(np.median(list(g_norm.values())))
    moved = [n for n in NAMES if g_norm[n] >= g_floor]
    delta = lambda out: {n: out["params"][n].double() - params0[n].double()  # noqa: E731
                         for n in NAMES}
    dead = (1.0 if int(prog["step_count"]) != int(ref["step_count"]) else
            float((prog["last_active"].long() != ref["last_active"].long()).double().mean()))
    return {
        "loss": loss,
        "grad1": max(leaf_gaps(prog["grad1"], ref["grad1"]).values()),
        "delta3": max(leaf_gaps(delta(prog), delta(ref), keep=moved).values()),
        "dead": dead,
    }
