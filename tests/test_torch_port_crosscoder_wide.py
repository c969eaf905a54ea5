"""The crosscoder's composed route at S > 3072 against the JAX package,
on the CPU.  The coder kernel takes these widths (its wide route); the
port composes past its 48 MiB budget, as the JAX package does beyond
``fused_coder_supported`` (``models/crosscoder.py:180-185``, ``:227-236``),
and these tests hold that route with the port's coder gate patched off
(``port_composed``): f32 products of bf16 operands, and for TopK the
top-k encode on the flattened view (kernel B's plain version here: bf16
W_enc within 48 MiB), as JAX ``crosscoder_apply`` encodes; the trainer takes the sliced
epoch.  At L=2, D=64, S=6144 (the widths of a whisper-base crosscoder at
its default expansion, S=4096, and above).

Tolerances: the loss at rtol 1e-3 and the selection l0 within 2% (bf16
products summed in another order by XLA and by torch, the bar of the AMP
trajectories in ``tests/test_torch_port_coders.py``); the AMP
trajectory's losses at rtol 1e-3.

Run as a script, it trains ``chip_smoke.py``'s phase-18 ReLU crosscoder
(L=2, D=384, S=6144, 32,768 rows drawn by the same recipe on the CPU,
batch 4096, the launcher's defaults, AMP) through both launchers on the
CPU from the same initial parameters and in the same batch order, at the
learning rates phase 18 has used, and prints both loss trajectories::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_port_crosscoder_wide.py
"""

from __future__ import annotations

import importlib.util
import json
import sys
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_sae_tpu.config import TrainingConfig as JTrainingConfig
from whisper_sae_tpu.models import crosscoder as jxc
from whisper_sae_tpu.training import coder_trainers as jct
from whisper_sae_tpu_torch import launch
from whisper_sae_tpu_torch.config import DataConfig, TrainingConfig, WhisperConfig
from whisper_sae_tpu_torch.data.feature_cache import FeatureCache
from whisper_sae_tpu_torch.models import crosscoder as txc
from whisper_sae_tpu_torch.ops import _build
from whisper_sae_tpu_torch.ops.topk import plain_calls
from whisper_sae_tpu_torch.training import coder_trainers as tct
from whisper_sae_tpu_torch.utils.checkpoint import params_from_jax

L, D, S, K, B = 2, 64, 6144, 32, 64
N = 3 * B + 16
VARIANTS = {"topk": K, "relu": None}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One intra-op thread: the suite runs one worker process per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def port_composed(monkeypatch):
    """The port's crosscoder loss and trainer epoch composed, as past the
    coder kernel's budget: its gate off where it is used."""
    monkeypatch.setattr(txc, "coder_supported", lambda *a, **k: False)
    monkeypatch.setattr(tct, "coder_supported", lambda *a, **k: False)


def _params(seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    w_dec = rng.standard_normal((S, L, D))
    w_dec = 0.1 * w_dec / np.linalg.norm(w_dec.reshape(S, -1), axis=1)[:, None, None]
    p = {"w_enc": np.transpose(w_dec, (1, 2, 0)) * 3,
         "b_enc": rng.uniform(-1, 1, S) * 0.01,
         "w_dec": w_dec, "b_dec": rng.uniform(-1, 1, (L, D)) * 0.01}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _no_kernel(*a, **k):
    raise AssertionError("the coder kernel ran with its gate off")


@pytest.mark.parametrize("variant", VARIANTS)
def test_wide_crosscoder_loss_composes_like_jax(variant, monkeypatch):
    k = VARIANTS[variant]
    assert S > _build.MAX_ROW
    monkeypatch.setattr(txc, "fused_transcoder_loss", _no_kernel)
    monkeypatch.setattr(txc, "fused_relu_crosscoder_loss", _no_kernel)
    params = _params(1)
    acts = np.random.default_rng(2).standard_normal((L, B, D)).astype(np.float32)
    jl, jaux = jxc.crosscoder_loss({n: jnp.asarray(v) for n, v in params.items()},
                                   jnp.asarray(acts), k=k, compute_dtype=jnp.bfloat16)
    plain_calls.clear()
    tl, taux = txc.crosscoder_loss(params_from_jax(params), torch.from_numpy(acts), k=k,
                                   compute_dtype=torch.bfloat16)
    assert plain_calls["fused_topk_encode"] == (1 if k else 0)
    assert plain_calls["topk_mask_wide"] == 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    for key in ("reconstruction_loss", "sparsity_loss"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]), rtol=1e-3, atol=1e-7)
    assert float(taux["l0"]) == pytest.approx(float(jaux["l0"]), rel=2e-2)
    if k:
        assert float(taux["l0"]) == pytest.approx(K, abs=0.5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_wide_crosscoder_trainer_matches_jax(variant, tmp_path, monkeypatch):
    """2 epochs of 3 steps and a 16-row remainder under AMP, the same
    batch order on both sides; the port's trainer takes the sliced epoch
    and never the coder kernel."""
    k = VARIANTS[variant]
    monkeypatch.setattr(txc, "fused_transcoder_loss", _no_kernel)
    monkeypatch.setattr(txc, "fused_relu_crosscoder_loss", _no_kernel)
    monkeypatch.setattr(tct, "fused_transcoder_loss_indexed", _no_kernel)
    monkeypatch.setattr(tct, "fused_relu_crosscoder_loss_indexed", _no_kernel)
    params = _params(3)
    data = np.random.default_rng(4).standard_normal((N, L, D)).astype(np.float32)
    perms = [np.random.default_rng(5 + e).permutation(N) for e in range(2)]
    kw = dict(batch_size=B, learning_rate=1e-3, epochs=2, warmup_steps=2, use_amp=True, seed=3)
    jm = jxc.create_crosscoder(D, L, S, k=K, use_topk=k is not None,
                               params={n: jnp.asarray(v) for n, v in params.items()})
    tm = txc.create_crosscoder(D, L, S, k=K, use_topk=k is not None,
                               params=params_from_jax(params), device="cpu")
    jt = jct.CrosscoderTrainer(jm, JTrainingConfig(**kw), run_dir=tmp_path / "j")
    tt = tct.CrosscoderTrainer(tm, TrainingConfig(**kw), run_dir=tmp_path / "t")
    assert not tt._use_indexed_epoch()
    for t in (jt, tt):
        t.setup_scheduler(2 * (N // B + 1))
    jl = [m.loss for p in perms for m in jt.train_epoch_fused(jnp.asarray(data), perm=p)]
    tl = [m.loss for p in perms for m in tt.train_epoch_fused(torch.from_numpy(data), perm=p)]
    assert len(tl) == len(jl) == 2 * (N // B + 1)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    np.testing.assert_allclose(txc.decoder_norms(tt.model.params).detach().numpy(), 1.0,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# the ReLU crosscoder at S=6144 through both launchers: its loss rises at
# the first update in the reference as in the port
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parent.parent
RANK = 64


def _two_layer_cache(root: Path, n: int, d: int, seed: int = 91) -> Path:
    """Layers 0 and 1 drawn as ``chip_smoke.py``'s phase 18 draws them
    (rows of rank-64 structure plus noise; layer 1 = 0.8 x layer 0 + 0.2 x
    fresh rows), from a CPU generator."""
    g = torch.Generator().manual_seed(seed)
    mix = torch.randn(RANK, d, generator=g) / RANK ** 0.5

    def rows():
        z = torch.randn(n, RANK, generator=g)
        return z @ mix + 0.1 * torch.randn(n, d, generator=g)

    x0 = rows()
    x1 = 0.8 * x0 + 0.2 * rows()
    cache = FeatureCache(root / "features", WhisperConfig(), DataConfig())
    for layer, r in ((0, x0), (1, x1)):
        w = cache.writer("encoder", layer)
        w.append(r.numpy())
        w.finalize(num_samples=max(1, n // 1500))
    return root


def _jax_launcher():
    spec = importlib.util.spec_from_file_location("_jax_launcher", REPO / "launcher" / "launch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def relu_crosscoder_both(cache_dir: Path, out: Path, d: int, **kw) -> dict:
    """The ReLU crosscoder (layers 0 and 1, expansion 16: S = 16 d) through
    the JAX launcher and the port's on the CPU from the JAX initial
    parameters, both streamed batch by batch (the multi-layer loader's
    numpy order, the same on both sides; a resident epoch is shuffled by
    ``jax.random`` in one and ``torch.randperm`` in the other); returns
    each side's per-step losses and the decoder norms before and after."""
    init = {k: np.asarray(v) for k, v in jxc.create_crosscoder(
        d, 2, 16 * d, use_topk=False, layer_indices=[0, 1], seed=0).params.items()}
    real_j, real_t = jxc.create_crosscoder, txc.create_crosscoder

    def jcreate(*a, **k_):
        m = real_j(*a, **k_)
        m.params = {k: jnp.asarray(v) for k, v in init.items()}
        return m

    def tcreate(*a, **k_):
        m = real_t(*a, **k_)
        m.load_params(init)
        return m

    args = dict(component="encoder", layers="0,1", expansion_factor=16, use_topk=False,
                cache_dir=cache_dir, max_resident_bytes=0, **kw)
    with ExitStack() as stack:
        stack.enter_context(mock.patch.object(jxc, "create_crosscoder", jcreate))
        stack.enter_context(mock.patch.object(launch, "create_crosscoder", tcreate))
        runs = {"jax": _jax_launcher().train_crosscoder(output_dir=out / "jax", **args),
                "port": launch.train_crosscoder(output_dir=out / "port", device="cpu", **args)}
    res = {"init_decoder_norm": float(np.linalg.norm(init["w_dec"].reshape(16 * d, -1),
                                                     axis=1).mean())}
    for side, run in runs.items():
        rows = json.loads((Path(run["run_dir"]) / "metrics.json").read_text())
        res[side] = [r["loss"] for r in rows]
        with np.load(Path(run["run_dir"]) / "crosscoder_final.npz") as z:
            res[f"{side}_final_decoder_norm"] = float(np.linalg.norm(
                z["w_dec"].reshape(16 * d, -1), axis=1).mean())
    return res


def test_relu_crosscoder_first_update_raises_the_loss_in_both(tmp_path):
    """At S=6144 (D=384) under AMP, one epoch of 3 steps at learning rate
    1e-3: the loss rises after the first update in the JAX launcher's run
    and in the port's alike, and the two trajectories agree at rtol 1e-3.
    The decoder starts at norm 0.1 a feature and every step renormalises it
    to 1, which scales the reconstruction and the L1 term at once."""
    cache = _two_layer_cache(tmp_path / "cache", 1536, 384)
    res = relu_crosscoder_both(cache, tmp_path, 384, batch_size=512, learning_rate=1e-3,
                               epochs=1)
    jl, tl = res["jax"], res["port"]
    assert len(jl) == len(tl) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert jl[1] > jl[0] and tl[1] > tl[0]
    assert res["init_decoder_norm"] == pytest.approx(0.1, rel=1e-5)
    assert res["jax_final_decoder_norm"] == pytest.approx(1.0, rel=1e-5)
    assert res["port_final_decoder_norm"] == pytest.approx(1.0, rel=1e-5)


if __name__ == "__main__":
    import tempfile

    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        root = Path(tmp)
        cache = _two_layer_cache(root / "cache", 8 * 4096, 384)
        for lr, epochs in ((1e-2, 2), (1e-3, 4)):
            res = relu_crosscoder_both(cache, root / f"lr{lr}", 384, batch_size=4096,
                                       learning_rate=lr, epochs=epochs)
            print(json.dumps({"learning_rate": lr, "epochs": epochs, **res}))
            sys.stdout.flush()
