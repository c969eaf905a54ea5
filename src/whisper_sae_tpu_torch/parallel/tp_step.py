"""dp x tp train steps for the coder families, collectives written out
(counterpart of ``whisper_sae_tpu/parallel/tp_step.py``).

Each rank holds its block of the feature dim (``model``) and its block of
the batch rows (``data``)::

    pre_local    = x_local @ w_enc_local [- b_pre for the SAE]   (no comms)
    hidden_local = top-k mask with the GLOBAL threshold          (32 x [B,1]
                   int32 all-reduces over model -- tp_topk.py)
    recon        = all_reduce_model(hidden_local @ w_dec_local   (one [B, D]
                   + replicated_terms / n_model)                  all-reduce)
    loss         = local squared error / N_global
    grads        = autograd through the collectives, then one
                   all_reduce over ``data`` (the gradient all-reduce)

Per-feature state (b_enc, the dead-feature counters) and w_enc/w_dec stay
sharded; the decoder renorm is local because a feature's decoder row is
whole on its rank.

The replicated-leaf trick: the decoder-path terms of replicated
parameters (b_dec, b_pre, w_skip, b_skip) enter the model all-reduce at
1/n_model, so every rank takes a 1/n_model share of their gradient and
one all-reduce over ``model`` afterwards gives the exact total -- the
same bits on every rank, so replicated parameters never drift apart.

The all-reduce of the recon is :func:`psum_identity_vjp`: its backward
passes the gradient through unchanged, the exact VJP of a sum over ranks
whose output gradient is the same on every rank.  (An all-reduce whose
backward all-reduces again scales every upstream gradient by the group
size -- the JAX package measured w_enc gradients 8x on a 2x4 mesh.)

Products in bf16 mode are f32 products of bf16 operands (``mm_f32``, TF32
off), as ``jnp.dot(..., preferred_element_type=f32)`` is; the JAX package
computes this forward in plain XLA (no Pallas kernel), so it is plain
PyTorch here.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from ..models.crosscoder import normalize_crosscoder_decoder
from ..models.sae import DeadFeatureState, dead_feature_mask, normalize_decoder, update_dead_state
from ..ops.topk import relu
from ..utils.device import f32_matmuls, mm_f32
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh
from .sharding import batch_sharding, shard_leaf
from .tp_topk import topk_mask_sharded

METRIC_KEYS = ("loss", "reconstruction_loss", "sparsity_loss", "l0", "dead_feature_ratio")


class TPAxes(NamedTuple):
    """The mesh as a step sees it: the axis sizes and groups.  With
    ``data_group`` None the step reduces nothing over ``data`` and counts
    one data rank (every rank takes the whole batch: the remainder); a
    one-rank data axis reduces nothing either."""

    n_data: int
    n_model: int
    data_group: object
    model_group: object


def mesh_axes(mesh: Mesh, reduce_data: bool = True) -> TPAxes:
    if not reduce_data:
        return TPAxes(1, mesh.shape[MODEL_AXIS], None, mesh.model_group)
    return TPAxes(mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS], mesh.data_group,
                  mesh.model_group)


class TPFamily(NamedTuple):
    """What the shared dp x tp step needs of a coder family: the dimension
    each parameter splits on over ``model`` (``None``: replicated), the
    local forward with its collectives, and the in-place local decoder
    renorm."""

    name: str
    param_specs: dict
    forward: Callable  # (params, batch, compute_dtype, TPAxes) -> (loss, metrics)
    renorm_fn: Callable  # params -> None, in place


class _PsumIdentityVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum_identity_vjp(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) over ``group`` whose backward passes the gradient
    through unchanged.  The forward is the genuine sum, the same bits on
    every rank of the group."""
    return _PsumIdentityVJP.apply(x, group)


def _metric_collectives(hidden: torch.Tensor, sq: torch.Tensor, n_global: int, rows_local: int,
                        ax: TPAxes, sp_local: torch.Tensor | None = None) -> dict:
    """The family-independent metric reductions: the global loss (over
    data), the global L0 (over both axes), a feature active if ANY data
    rank fired it, and (ReLU crosscoder) the global sparsity term."""
    fired = hidden.detach() > 0
    model_buf = fired.sum().float().reshape(1)
    if sp_local is not None:
        model_buf = torch.cat([model_buf, sp_local.detach().reshape(1)])
    dist.all_reduce(model_buf, group=ax.model_group)
    buf = torch.cat([sq.detach().reshape(1), model_buf, fired.any(dim=0).float()])
    if ax.data_group is not None and ax.n_data > 1:
        dist.all_reduce(buf, group=ax.data_group)
    out = {"loss_metric": buf[0] / n_global, "l0": buf[1] / (rows_local * ax.n_data),
           "active": buf[len(model_buf) + 1:] > 0,
           "sparsity_loss": torch.zeros((), device=hidden.device)}
    if sp_local is not None:
        out["sparsity_loss"] = buf[2]
    return out


def _mm(a: torch.Tensor, b: torch.Tensor, compute_dtype) -> torch.Tensor:
    return mm_f32(a.to(compute_dtype), b.to(compute_dtype))


# ---------------------------------------------------------------------------
# families
# ---------------------------------------------------------------------------


@torch.no_grad()
def _renorm_rows(p: dict) -> None:
    p["w_dec"].copy_(normalize_decoder(p)["w_dec"])


@torch.no_grad()
def _renorm_crosscoder(p: dict) -> None:
    p["w_dec"].copy_(normalize_crosscoder_decoder(p)["w_dec"])


def sae_family(k: int) -> TPFamily:
    """TopK SAE: batch [B, D]; w_enc [D, H], b_enc [H], w_dec [H, D], b_dec
    and b_pre [D]."""

    def forward(p, batch, compute_dtype, ax: TPAxes):
        xc = batch - p["b_pre"]
        pre = _mm(xc, p["w_enc"], compute_dtype) + p["b_enc"]
        hidden = topk_mask_sharded(pre, k, ax.model_group)
        recon_part = _mm(hidden, p["w_dec"], compute_dtype)
        recon = psum_identity_vjp(recon_part + (p["b_dec"] + p["b_pre"]) / ax.n_model,
                                  ax.model_group)
        sq = torch.sum(torch.square(recon - batch))
        n_global = batch.shape[0] * ax.n_data * batch.shape[1]
        # differentiate the LOCAL share (gradients are summed over data);
        # report the global loss as the metric
        return sq / n_global, _metric_collectives(hidden, sq, n_global, batch.shape[0], ax)

    return TPFamily("sae", {"w_enc": 1, "b_enc": 0, "w_dec": 0, "b_dec": None, "b_pre": None},
                    forward, _renorm_rows)


def relu_sae_family(sparsity_weight: float) -> TPFamily:
    """ReLU SAE (``relu_sae_apply``): batch [B, D]; w_enc [D, H], b_enc
    [H], w_dec [H, D], b_dec [D] replicated.  The activation is
    elementwise, so there is no threshold collective; the L1 term
    mean|hidden| splits per feature block (each rank sums its own block
    over the GLOBAL rows times the GLOBAL H, and the data all-reduce of
    the gradients completes the mean)."""

    def forward(p, batch, compute_dtype, ax: TPAxes):
        hidden = relu(_mm(batch, p["w_enc"], compute_dtype) + p["b_enc"])
        recon_part = _mm(hidden, p["w_dec"], compute_dtype)
        recon = psum_identity_vjp(recon_part + p["b_dec"] / ax.n_model, ax.model_group)
        sq = torch.sum(torch.square(recon - batch))
        rows = batch.shape[0] * ax.n_data
        n_global = rows * batch.shape[1]
        sp_local = torch.sum(torch.abs(hidden)) / (rows * hidden.shape[1] * ax.n_model)
        loss = sq / n_global + sparsity_weight * sp_local
        metrics = _metric_collectives(hidden, sq, n_global, batch.shape[0], ax, sp_local)
        metrics["recon_metric"] = metrics["loss_metric"]
        metrics["loss_metric"] = metrics["loss_metric"] + sparsity_weight * metrics["sparsity_loss"]
        return loss, metrics

    return TPFamily("relu_sae", {"w_enc": 1, "b_enc": 0, "w_dec": 0, "b_dec": None}, forward,
                    _renorm_rows)


def transcoder_family(k: int, use_skip: bool) -> TPFamily:
    """TopK / Skip transcoder: batch (x [B, Din], y [B, Dout]); the skip
    path replicates and its term rides inside the model all-reduce at
    1/n_model."""

    def forward(p, batch, compute_dtype, ax: TPAxes):
        x, y = batch
        pre = _mm(x, p["w_enc"], compute_dtype) + p["b_enc"]
        hidden = topk_mask_sharded(pre, k, ax.model_group)
        pred_part = _mm(hidden, p["w_dec"], compute_dtype)
        repl = p["b_dec"]
        if use_skip:
            repl = repl + (_mm(x, p["w_skip"], compute_dtype) + p["b_skip"])
        pred = psum_identity_vjp(pred_part + repl / ax.n_model, ax.model_group)
        sq = torch.sum(torch.square(pred - y))
        n_global = y.shape[0] * ax.n_data * y.shape[1]
        return sq / n_global, _metric_collectives(hidden, sq, n_global, y.shape[0], ax)

    specs = {"w_enc": 1, "b_enc": 0, "w_dec": 0, "b_dec": None}
    if use_skip:
        specs.update(w_skip=None, b_skip=None)
    return TPFamily("transcoder", specs, forward, _renorm_rows)


_CROSSCODER_SPECS = {"w_enc": 2, "b_enc": 0, "w_dec": 0, "b_dec": None}


def crosscoder_family(k: int) -> TPFamily:
    """TopK crosscoder on token-major [B, L, D] batches: on the flattened
    [B, L*D] view a transcoder with y = x; S splits over ``model``.  The
    sum of per-layer MSEs equals sq / (B_global * D)."""

    def forward(p, batch, compute_dtype, ax: TPAxes):
        b, l, d = batch.shape
        x2d = batch.reshape(b, l * d)
        pre = _mm(x2d, p["w_enc"].reshape(l * d, -1), compute_dtype) + p["b_enc"]
        hidden = topk_mask_sharded(pre, k, ax.model_group)
        recon_part = _mm(hidden, p["w_dec"].reshape(p["w_dec"].shape[0], l * d), compute_dtype)
        recon = psum_identity_vjp(recon_part + p["b_dec"].reshape(l * d) / ax.n_model,
                                  ax.model_group)
        sq = torch.sum(torch.square(recon - x2d))
        n_global = b * ax.n_data * d
        return sq / n_global, _metric_collectives(hidden, sq, n_global, b, ax)

    return TPFamily("crosscoder", dict(_CROSSCODER_SPECS), forward, _renorm_crosscoder)


def relu_crosscoder_family(sparsity_weight: float) -> TPFamily:
    """ReLU crosscoder (decoder-norm-weighted L1): the activation is
    elementwise, so there is no threshold collective; the sparsity term
    splits per feature block (each rank differentiates its own share,
    over the GLOBAL row count, and the data all-reduce of the gradients
    completes the mean)."""

    def forward(p, batch, compute_dtype, ax: TPAxes):
        b, l, d = batch.shape
        x2d = batch.reshape(b, l * d)
        pre = _mm(x2d, p["w_enc"].reshape(l * d, -1), compute_dtype) + p["b_enc"]
        hidden = relu(pre)
        w_dec = p["w_dec"].reshape(p["w_dec"].shape[0], l * d)
        recon_part = _mm(hidden, w_dec, compute_dtype)
        recon = psum_identity_vjp(recon_part + p["b_dec"].reshape(l * d) / ax.n_model,
                                  ax.model_group)
        sq = torch.sum(torch.square(recon - x2d))
        n_global = b * ax.n_data * d
        norms_local = torch.linalg.vector_norm(p["w_dec"].reshape(p["w_dec"].shape[0], -1), dim=1)
        with f32_matmuls():
            sp_local = torch.sum(torch.matmul(torch.abs(hidden), norms_local)) / (b * ax.n_data)
        loss = sq / n_global + sparsity_weight * sp_local
        metrics = _metric_collectives(hidden, sq, n_global, b, ax, sp_local)
        metrics["recon_metric"] = metrics["loss_metric"]
        metrics["loss_metric"] = metrics["loss_metric"] + sparsity_weight * metrics["sparsity_loss"]
        return loss, metrics

    return TPFamily("relu_crosscoder", dict(_CROSSCODER_SPECS), forward, _renorm_crosscoder)


DSTATE_SPECS = DeadFeatureState(feature_last_activated=0, step_count=None)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _flat_all_reduce(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """One all-reduce (sum) of several tensors flattened into one buffer."""
    if not tensors:
        return []
    buf = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(buf, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(buf[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def _distributed_clip(grads: dict, param_specs: dict, clip: float, ax: TPAxes) -> dict:
    """Global-norm clip where the sharded leaves contribute their squares
    summed over ``model`` (a local clip would see only this rank's norm)."""
    zero = torch.zeros((), device=next(iter(grads.values())).device)
    sq = sum((torch.sum(torch.square(g).float()) for k, g in grads.items()
              if param_specs[k] is None), zero)
    sq_sharded = sum((torch.sum(torch.square(g).float()) for k, g in grads.items()
                      if param_specs[k] is not None), zero).reshape(1)
    dist.all_reduce(sq_sharded, group=ax.model_group)
    norm = torch.sqrt(sq + sq_sharded[0])
    scale = clip / torch.clamp(norm, min=clip)
    return {k: g * scale for k, g in grads.items()}


def _make_local_step(family: TPFamily, compute_dtype, ax: TPAxes, dead_feature_threshold: int,
                     schedule: Callable, weight_decay: float, renorm: bool,
                     gradient_clip: float | None) -> Callable:
    """The per-rank step shared by the per-step and fused-epoch paths:
    (params, opt_state, dstate, batch_local) -> (opt_state, dstate, the
    step's ``METRIC_KEYS`` as one [5] tensor on the device); ``params``
    (this rank's blocks) are updated in place."""
    from ..training.trainer import adamw_update_, clip_by_global_norm

    replicated = [name for name, spec in family.param_specs.items() if spec is None]

    def local_step(params, opt_state, dstate, batch):
        with f32_matmuls():
            loss, aux = family.forward(params, batch, compute_dtype, ax)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        with torch.no_grad():
            if ax.data_group is not None and ax.n_data > 1:  # the gradient all-reduce
                grads = dict(zip(grads, _flat_all_reduce(list(grads.values()), ax.data_group)))
            # replicated leaves carry per-rank shares (their decoder terms
            # entered the recon all-reduce at 1/n_model, their encoder-path
            # terms flow through the local features only): the model
            # all-reduce completes them, the same bits on every rank
            grads.update(zip(replicated, _flat_all_reduce([grads[n] for n in replicated],
                                                          ax.model_group)))
            if gradient_clip is not None:
                grads = _distributed_clip(grads, family.param_specs, gradient_clip, ax)
                # the optimizer's own clip, as optax's chain applies it:
                # a no-op once the global norm is within the bound
                grads = clip_by_global_norm(grads, gradient_clip)
            lr = schedule(opt_state.count)
            opt_state = adamw_update_(params, grads, opt_state, lr, weight_decay)
            if renorm:
                family.renorm_fn(params)
            dstate = update_dead_state(dstate, aux["active"])
            dead = dead_feature_mask(dstate, dead_feature_threshold).sum().float().reshape(1)
            dist.all_reduce(dead, group=ax.model_group)
            h_local = params["b_enc"].shape[0]
            metrics = torch.stack([
                aux["loss_metric"],
                # families whose loss has a sparsity term report the
                # reconstruction part apart
                aux.get("recon_metric", aux["loss_metric"]),
                aux["sparsity_loss"], aux["l0"], dead[0] / (h_local * ax.n_model)])
        return opt_state, dstate, metrics

    return local_step


def _shape_spec_map(example_params: dict, param_specs: dict) -> dict:
    """shape -> split dimension, for placing optimizer-state leaves (AdamW
    moments mirror the parameter shapes).  Raises if two parameters share
    a shape but split differently -- pick a geometry that keeps the shapes
    apart (H is 8-32x D in practice)."""
    m: dict = {}
    for name, leaf in example_params.items():
        shape, spec = tuple(leaf.shape), param_specs[name]
        if shape in m and m[shape] != spec:
            raise ValueError(f"ambiguous TP placement: shape {shape} maps to both "
                             f"{m[shape]} and {spec}")
        m[shape] = spec
    return m


def _opt_specs(example_params: dict, example_opt_state, param_specs: dict) -> dict:
    """The split dimension of each AdamW moment, by its shape."""
    shape_map = _shape_spec_map(example_params, param_specs)
    return {part: {name: shape_map.get(tuple(leaf.shape)) for name, leaf in moments.items()}
            for part, moments in (("mu", example_opt_state.mu), ("nu", example_opt_state.nu))}


def build_tp_train_step(family: TPFamily, compute_dtype, mesh: Mesh, dead_feature_threshold: int,
                        schedule: Callable, weight_decay: float, renorm: bool = True,
                        gradient_clip: float | None = None, reduce_data: bool = True
                        ) -> Callable:
    """The dp x tp step: (params, opt_state, dstate, batch_local) ->
    (opt_state, dstate, [5] metrics of global scalars); ``schedule(count)``
    gives the learning rate of the update at AdamW count ``count``.

    With ``reduce_data=False`` every rank steps on the whole batch it is
    given and nothing is reduced over ``data`` (the remainder batch, at
    single-device semantics)."""
    return _make_local_step(family, compute_dtype, mesh_axes(mesh, reduce_data),
                            dead_feature_threshold, schedule, weight_decay, renorm, gradient_clip)


def build_tp_epoch_fn(family: TPFamily, compute_dtype, mesh: Mesh, dead_feature_threshold: int,
                      schedule: Callable, weight_decay: float,
                      metric_keys: tuple[str, ...] = METRIC_KEYS, renorm: bool = True,
                      gradient_clip: float | None = None) -> Callable:
    """A fused epoch: the local step over [S, B_local, ...] staged batches
    (a tensor, or a tuple of them), the metrics kept on the device ->
    (opt_state, dstate, stacked [S, len(metric_keys)]), fetched once by
    the caller."""
    local_step = build_tp_train_step(family, compute_dtype, mesh, dead_feature_threshold,
                                     schedule, weight_decay, renorm, gradient_clip)
    cols = [METRIC_KEYS.index(k) for k in metric_keys]

    def epoch(params, opt_state, dstate, batches):
        steps = (batches[0] if isinstance(batches, tuple) else batches).shape[0]
        rows = []
        for s in range(steps):
            batch = tuple(a[s] for a in batches) if isinstance(batches, tuple) else batches[s]
            opt_state, dstate, m = local_step(params, opt_state, dstate, batch)
            rows.append(m[cols])
        return opt_state, dstate, torch.stack(rows)

    return epoch


def batch_shardings(mesh: Mesh, family: TPFamily | None = None) -> Callable:
    """-> a function giving this rank's rows of a global batch (a tensor or
    a tuple of them): its block over ``data``."""

    def local(batch):
        rows = (batch[0] if isinstance(batch, tuple) else batch).shape[0]
        block = batch_sharding(mesh, rows)
        return tuple(a[block] for a in batch) if isinstance(batch, tuple) else batch[block]

    return local


def place_for_tp(mesh: Mesh, family: TPFamily, params: dict, opt_state, dstate: DeadFeatureState):
    """Full parameters, AdamW state and dead-feature state -> this rank's
    blocks by the family's layout; the moments split like their
    parameters (by shape, as the JAX package places them)."""
    from ..training.trainer import AdamWState

    specs = _opt_specs(params, opt_state, family.param_specs)
    local = {k: shard_leaf(mesh, v.detach(), family.param_specs[k]) for k, v in params.items()}
    mu = {k: shard_leaf(mesh, v, specs["mu"][k]) for k, v in opt_state.mu.items()}
    nu = {k: shard_leaf(mesh, v, specs["nu"][k]) for k, v in opt_state.nu.items()}
    dstate = DeadFeatureState(shard_leaf(mesh, dstate.feature_last_activated, 0),
                              dstate.step_count.clone())
    return local, AdamWState(mu, nu, opt_state.count), dstate
