"""The training mix: ``SAETrainer.train_epochs_fused`` over a
device-resident stack of f32 rows, an epoch a call.

The mix's file gives ``batch``, ``steps_per_epoch`` (the stack holds
that many batches), ``shuffle``, ``schedule_total_steps`` and
``trace_seconds``; the configuration gives the SAE (``sae``) and its
training recipe (``training``) at the input width ``d_model``.

Set-up builds one trainer from the seed's parameters and drives its
first three steps through the window's own call, on rows that all
differ: an epoch of one batch, then an epoch of two.  The same trainer
then runs the window's call once on the window's stack, which warms its
shapes; of that epoch the check keeps, for a middle and the last step,
the parameters the step started from and the loss it reported.  The
window repeats that call.  Once the window has closed, the check
compares the first three steps with the plain reference
(``reference/sae_train``) from the seed, and the two late steps with
it teacher-forced, from the program's parameters before each: the
late steps read rows far into the epoch's gathered buffer (past 2^32
bytes at batch 32768), which the first three never reach.
"""

from __future__ import annotations

import functools
import itertools
import math
import tempfile
from pathlib import Path

import torch

from harness import spans
from inputs import sae as inputs
from reference import sae_train as ref

CHECK_CALLS = (1, 2)  # batches in each of the check's epochs: three steps


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        sae = cfg["sae"]
        self.d = cfg["d_model"]
        self.h = self.d * sae["expansion_factor"]
        self.k = sae["k"]
        self.b = traffic["batch"]
        self.attempted = self.failed = 0

    def recipe(self) -> ref.Recipe:
        t = self.cfg["training"]
        return ref.Recipe(k=self.k, batch=self.b, lr=t["learning_rate"], warmup=t["warmup_steps"],
                          total_steps=self.traffic["schedule_total_steps"],
                          clip=t["gradient_clip"], weight_decay=t["weight_decay"],
                          seed=self.trainer_seed)

    @property
    def trainer_seed(self) -> int:
        return self.seed % (1 << 31)

    def setup(self) -> None:
        self.build()
        self.stack = inputs.rows(self.traffic["steps_per_epoch"] * self.b, self.d, self.seed,
                                 "sae.stack", self.device)
        self.late = self._window_epoch()
        self.sync()
        self.attempted = self.failed = 0

    def late_steps(self) -> tuple[int, int]:
        """The late steps the check compares: a middle one and the last."""
        n = self.traffic["steps_per_epoch"]
        return n // 2, n - 1

    def _window_epoch(self) -> dict:
        """The window's call, once: every shape it uses.  -> for each late
        step, the parameters it started from (kept by a wrapper around
        ``SAETrainer._step``, from the benchmark's side) and its loss."""
        from whisper_sae_tpu_torch.training.trainer import SAETrainer

        late = set(self.late_steps())
        kept: dict[int, dict] = {}
        counter = itertools.count()

        def keep_params(step, _name):
            @functools.wraps(step)
            def kept_step(trainer, *args, **kwargs):
                s = next(counter)
                if s in late:
                    kept[s] = {k: v.detach().clone() for k, v in trainer.model.params.items()}
                return step(trainer, *args, **kwargs)

            return kept_step

        with spans.installed([(SAETrainer, "_step", "check.late")], keep_params):
            metrics = self._call()
        return {"params": kept, "loss": {s: metrics[s].loss for s in kept}}

    def build(self) -> None:
        """The trainer and its first steps: all that the check reads."""
        from whisper_sae_tpu_torch.config import TrainingConfig
        from whisper_sae_tpu_torch.models.sae import TopKSAE
        from whisper_sae_tpu_torch.training.trainer import SAETrainer

        sae, t = self.cfg["sae"], self.cfg["training"]
        self.params0 = inputs.params(self.d, self.h, self.seed, self.device)
        model = TopKSAE(self.d, self.h, k=self.k, normalize_decoder=sae["normalize_decoder"],
                        dead_feature_threshold=sae["dead_feature_threshold"],
                        params=self.params0, device=self.device)
        self._run_dir = tempfile.TemporaryDirectory(prefix="bench-train-")
        self.trainer = SAETrainer(
            model, TrainingConfig(batch_size=self.b, learning_rate=t["learning_rate"],
                                  weight_decay=t["weight_decay"], warmup_steps=t["warmup_steps"],
                                  gradient_clip=t["gradient_clip"], use_amp=t["use_amp"],
                                  seed=self.trainer_seed),
            run_dir=Path(self._run_dir.name))
        self.trainer.setup_scheduler(self.traffic["schedule_total_steps"])
        self.check_rows = inputs.rows(sum(CHECK_CALLS) * self.b, self.d, self.seed, "sae.check",
                                      self.device)
        self.program = self._first_steps()

    def _check_calls(self) -> list[torch.Tensor]:
        """The check's rows, one block an epoch."""
        ends = [self.b * sum(CHECK_CALLS[:i + 1]) for i in range(len(CHECK_CALLS))]
        return [self.check_rows[e - n * self.b:e] for e, n in zip(ends, CHECK_CALLS)]

    def _first_steps(self) -> dict:
        tr = self.trainer
        out: dict = {"loss": [], "l0": []}
        for i, rows in enumerate(self._check_calls()):
            for m in tr.train_epochs_fused(rows, epochs=1, shuffle=self.traffic["shuffle"]):
                out["loss"].append(m.loss)
                out["l0"].append(m.l0)
            if i == 0:
                out["grad1"] = {k: v.detach() / (1.0 - ref.B1) for k, v in tr.opt_state.mu.items()}
        out["params"] = {k: v.detach().clone() for k, v in tr.model.params.items()}
        out["last_active"] = tr.model.feature_last_activated.clone()
        out["step_count"] = int(tr.model.step_count)
        return out

    def _call(self) -> list:
        metrics = self.trainer.train_epochs_fused(self.stack, epochs=1,
                                                  shuffle=self.traffic["shuffle"])
        self.attempted += len(metrics)
        self.failed += sum(not math.isfinite(m.loss) for m in metrics)
        return metrics

    def unit(self) -> int:
        return len(self._call()) * self.b

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def spans(self) -> list:
        from whisper_sae_tpu_torch.training.trainer import SAETrainer

        return [(SAETrainer, "_step", "trainer.step"),
                (SAETrainer, "_loss_fn", "sae.forward"),
                (SAETrainer, "_indexed_loss_fn", "sae.forward")]

    def route(self) -> dict[str, int]:
        """Launch counts of the SAE's kernels in this process: the route taken."""
        from whisper_sae_tpu_torch.ops import cuda_sae, topk

        return {"kernel_a": cuda_sae.fused_sae_loss_indexed.launches
                + cuda_sae.fused_sae_loss.launches,
                "topk_encode": cuda_sae.fused_topk_encode.launches,
                "blocked_encode": cuda_sae.fused_topk_encode.blocked_launches,
                "plain": sum(topk.plain_calls.values())}

    def window_rows(self, steps) -> dict[int, torch.Tensor]:
        """The rows of ``steps`` of the window call's first epoch (the
        trainer's third), in the order the reference works out."""
        return ref.epoch_rows(self.stack, self.recipe(), len(CHECK_CALLS), steps)

    def release(self) -> None:
        self.late_rows = self.window_rows(self.late["params"])
        self.trainer = self.stack = None
        self._run_dir.cleanup()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "bf16", half: bool = False) -> dict:
        return ref.train(self.params0, self._check_calls(), self.recipe(), precision, half)

    def late_reference(self, precision: str = "bf16", half: bool = False) -> dict[int, float]:
        """Each late step's loss, teacher-forced from the program's parameters."""
        return {s: ref.loss_at(p, self.late_rows[s], self.k, precision, half)
                for s, p in self.late["params"].items()}

    def check(self) -> dict[str, float]:
        numbers = ref.compare(self.program, self.reference(), self.params0)
        numbers["late_loss"] = ref.late_gap(self.late["loss"], self.late_reference())
        return numbers


def readings(drv: Driver) -> dict:
    """The readings that set this kind's limits (``calibrate.py``), for one
    seed at the cell's sizes: ``program``, the run's numbers; ``control``,
    the reference in fp8 in the program's place; ``half`` (half of each
    batch left out, the mean over the rest) and ``offset`` (each late
    step's loss on the rows of the step before it), the faults planted in
    the reference.  A step that leaves its state unchanged reads 1 on
    ``delta3`` by its definition and needs no run."""
    drv.setup()
    late = drv.late_steps()
    # the rows of the step before each late one: what a read at the wrong offset takes
    prev = drv.window_rows([s - 1 for s in late])
    drv.release()
    bf16, bf16_late = drv.reference(), drv.late_reference()

    def numbers(steps, late_losses):
        return {**ref.compare(steps, bf16, drv.params0),
                "late_loss": ref.late_gap(late_losses, bf16_late)}

    offset = {s: ref.loss_at(drv.late["params"][s], prev[s - 1], drv.k) for s in late}
    return {"program": numbers(drv.program, drv.late["loss"]),
            "control": numbers(drv.reference("fp8"), drv.late_reference("fp8")),
            "half": numbers(drv.reference(half=True), drv.late_reference(half=True)),
            "offset": {"late_loss": ref.late_gap(offset, bf16_late)}}
