"""The plain references against the port's CPU path at a toy size, and
the control (the reference in fp8, put in the program's place) failing
the whisper-tiny cells' limits there.  The same control at the cells'
own sizes is ``calibrate.py``'s, on the card (``test_control_on_card``)."""

from __future__ import annotations

import json

import pytest
import torch

from harness.spec import Spec

CPU = torch.device("cpu")
SEEDS = (3, 2_147_483_659)  # the second past 32 signed bits


def _driver(root, cell: str, seed: int):
    spec = Spec(root)
    c = spec.cell(cell)
    traffic = spec.traffic(c)
    return spec.driver(traffic["kind"]).Driver(spec.config(c), traffic, seed, CPU), spec.limits(c)


@pytest.mark.parametrize("seed", SEEDS)
def test_training_reference_follows_the_port(toy_root, seed):
    """The first three steps from the seed, and the window epoch's late
    steps teacher-forced: at the parameters a late step started from, on
    the rows the reference orders for it, the reference's loss is the one
    the port reported; on the step before's rows it is not."""
    from reference import sae_train as ref

    drv, limits = _driver(toy_root, "toy.train", seed)
    drv.setup()
    prev = drv.window_rows([s - 1 for s in drv.late_steps()])
    drv.release()
    numbers = drv.check()
    assert numbers["loss"] < 1e-6 and numbers["grad1"] < 1e-6 and numbers["delta3"] < 1e-4
    assert numbers["late_loss"] < 1e-6 and sorted(drv.late["params"]) == [2, 3]
    offset = {s: ref.loss_at(drv.late["params"][s], prev[s - 1], drv.k) for s in drv.late["loss"]}
    assert ref.late_gap(offset, drv.late_reference()) > 1e-4
    assert numbers["dead"] == 0.0
    assert all(numbers[k] <= v for k, v in limits.items())
    assert drv.program["l0"] == [32.0, 32.0, 32.0]


@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_fails(toy_root, seed):
    from reference import sae_train as ref

    drv, limits = _driver(toy_root, "toy.train", seed)
    drv.build()
    numbers = ref.compare(drv.reference("fp8"), drv.reference(), drv.params0)
    assert any(numbers[k] > v for k, v in limits.items()), numbers


@pytest.mark.parametrize("seed", SEEDS)
def test_extraction_reference_follows_the_port(toy_root, seed):
    drv, limits = _driver(toy_root, "toy.extract", seed)
    drv.build()
    drv.unit()
    drv.unit()
    numbers = drv.check()
    assert numbers["enc"] < 0.01 and numbers["dec"] < 0.01
    assert all(numbers[k] <= v for k, v in limits.items())


@pytest.mark.parametrize("seed", SEEDS)
def test_extraction_control_fails(toy_root, seed):
    from reference import whisper_extract as ref

    drv, limits = _driver(toy_root, "toy.extract", seed)
    drv.build()
    mel = drv.mels[0]
    enc, dec = ref.captures(drv.params, drv.cfg, mel, "fp8", block=2)
    numbers = ref.compare(drv.params, drv.cfg, mel, enc, dec, block=2)
    assert any(numbers[k] > v for k, v in limits.items()), numbers


def test_reference_permutation_is_the_trainers(toy_root):
    """The epoch order the reference works out is the one the trainer
    draws, for the same seed and epoch."""
    from reference import sae_train as ref
    from whisper_sae_tpu_torch.config import TrainingConfig
    from whisper_sae_tpu_torch.models.sae import TopKSAE
    from whisper_sae_tpu_torch.training.trainer import SAETrainer

    trainer = SAETrainer(TopKSAE(32, 64, k=4, device="cpu"),
                         TrainingConfig(batch_size=8, seed=1234), run_dir=toy_root / "run")
    for epoch in (0, 1, 5):
        assert torch.equal(trainer._epoch_permutation(100, None, epoch),
                           ref.permutation(100, 1234, epoch))


def test_reference_learning_rate_is_the_trainers(toy_root):
    from reference import sae_train as ref
    from whisper_sae_tpu_torch.training.schedule import warmup_cosine_schedule

    r = ref.Recipe(k=4, batch=8, lr=1e-4, warmup=1000, total_steps=1_000_000, clip=1.0,
                   weight_decay=0.0, seed=0)
    sched = warmup_cosine_schedule(1e-4, 1_000_000, 1000)
    for count in (0, 1, 2, 999, 1000, 500_000):
        assert ref.learning_rate(r, count) == pytest.approx(float(sched(count)), rel=1e-6)


@pytest.mark.cuda
def test_control_on_card(tmp_path):
    """On the card, at the cells' own sizes: the control fails each cell's
    limits on three seeds (``calibrate.py``)."""
    import subprocess
    import sys

    from conftest import BENCH, REPO

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    spec = Spec(REPO)
    for w in spec.data["workloads"]:
        out = tmp_path / f"{w['name']}.jsonl"
        subprocess.run([sys.executable, str(BENCH / "calibrate.py"), "--workload", w["name"],
                        "--seeds", "11,12,13", "--out", str(out)], check=True, cwd=REPO)
        limits = spec.limits(w)
        for line in out.read_text().splitlines():
            reading = json.loads(line)
            assert all(reading["program"][k] <= v for k, v in limits.items())
            assert any(reading["control"][k] > v for k, v in limits.items())
