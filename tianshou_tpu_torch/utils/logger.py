"""Loggers: a base logger with data scopes, tensorboard, wandb and a no-op
logger (port of ``tianshou_tpu/utils/logger.py``).

Four data scopes (train, test, update, info), each written at most once
per its interval, nested dicts flattened to ``scope/key`` scalars, and the
trainer's counters saved and restored for a resumed run.  Loggers take host
numbers: the trainers hand them what they have already read from the card.
``tensorboard`` and ``wandb`` are imported only where a logger that needs
them is built or read back.
"""

from __future__ import annotations

import contextlib
import os
import sys
from collections.abc import Callable
from enum import Enum
from numbers import Number

import numpy as np

__all__ = ["DataScope", "BaseLogger", "LazyLogger", "TensorboardLogger", "WandbLogger"]


class DataScope(Enum):
    TRAIN = "train"
    TEST = "test"
    UPDATE = "update"
    INFO = "info"


def _flatten(data: dict, prefix: str) -> dict[str, float]:
    out: dict[str, float] = {}
    for k, v in data.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        elif isinstance(v, Number | np.number | np.ndarray):
            arr = np.asarray(v)
            if arr.size == 1:
                out[key] = float(arr)
    return out


class BaseLogger:
    """Interval-gated scoped logging: a scope is written at ``step`` when
    ``step`` is at least its interval past the scope's last write."""

    def __init__(
        self,
        train_interval: int = 1000,
        test_interval: int = 1,
        update_interval: int = 1000,
        info_interval: int = 1,
    ):
        self.intervals = {
            DataScope.TRAIN: train_interval,
            DataScope.TEST: test_interval,
            DataScope.UPDATE: update_interval,
            DataScope.INFO: info_interval,
        }
        self.last_log = {scope: -1 for scope in DataScope}

    # -- to be implemented by concrete loggers ------------------------------
    def write(self, step: int, data: dict[str, float]) -> None:
        raise NotImplementedError

    def save_data(
        self,
        epoch: int,
        env_step: int,
        gradient_step: int,
        save_checkpoint_fn: Callable | None = None,
    ) -> None:
        if save_checkpoint_fn is not None:
            save_checkpoint_fn(epoch, env_step, gradient_step)

    def restore_data(self) -> tuple[int, int, int]:
        """``(epoch, env_step, gradient_step)`` to resume from."""
        return 0, 0, 0

    def finalize(self) -> None:
        pass

    # -- scope helpers -------------------------------------------------------
    def _log(self, scope: DataScope, data: dict, step: int) -> None:
        if step - self.last_log[scope] >= self.intervals[scope]:
            self.write(step, _flatten(data, scope.value))
            self.last_log[scope] = step

    def log_train_data(self, data: dict, step: int) -> None:
        self._log(DataScope.TRAIN, data, step)

    def log_test_data(self, data: dict, step: int) -> None:
        self._log(DataScope.TEST, data, step)

    def log_update_data(self, data: dict, step: int) -> None:
        self._log(DataScope.UPDATE, data, step)

    def log_info_data(self, data: dict, step: int) -> None:
        self._log(DataScope.INFO, data, step)


class LazyLogger(BaseLogger):
    """No-op logger."""

    def __init__(self):
        super().__init__()

    def write(self, step: int, data: dict[str, float]) -> None:
        pass


def _event_accumulator(path: str, **kwargs):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(path, **kwargs)
    acc.Reload()
    return acc


class TensorboardLogger(BaseLogger):
    """Scalars to a tensorboard event file through
    ``torch.utils.tensorboard.SummaryWriter``, and the counters saved and
    restored with them.  Building one needs the ``tensorboard`` package."""

    def __init__(self, log_dir: str, **kwargs):
        super().__init__(**kwargs)
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir)
        self.log_dir = log_dir

    def write(self, step: int, data: dict[str, float]) -> None:
        for k, v in data.items():
            self.writer.add_scalar(k, v, global_step=step)
        self.writer.flush()

    def save_data(self, epoch, env_step, gradient_step, save_checkpoint_fn=None) -> None:
        self.write(env_step, {"save/epoch": epoch, "save/env_step": env_step, "save/gradient_step": gradient_step})
        super().save_data(epoch, env_step, gradient_step, save_checkpoint_fn)

    def restore_data(self) -> tuple[int, int, int]:
        acc = _event_accumulator(self.log_dir)
        tags = acc.Tags().get("scalars", [])
        epoch, env_step, grad_step = (
            int(acc.Scalars(key)[-1].value) if key in tags else 0
            for key in ("save/epoch", "save/env_step", "save/gradient_step")
        )
        self.last_log[DataScope.TRAIN] = env_step - 1
        self.last_log[DataScope.UPDATE] = grad_step - 1
        return epoch, env_step, grad_step

    def restore_logged_data(self) -> dict[str, list[tuple[int, float]]]:
        """Every logged scalar series, ``tag -> [(step, value), ...]``."""
        acc = _event_accumulator(self.log_dir)
        return {tag: [(s.step, s.value) for s in acc.Scalars(tag)] for tag in acc.Tags().get("scalars", [])}

    def finalize(self) -> None:
        self.writer.close()


class WandbLogger(BaseLogger):
    """Weights & Biases logger.

    - ``resume_id`` resumes an existing run (``wandb.init(resume="allow")``).
    - ``save_data`` stores the trainer's counters in the run summary and,
      when ``save_checkpoint_fn`` returns a path that exists, uploads it as
      a ``run_<id>_checkpoint`` artifact.
    - ``restore_data`` reads the counters back from the resumed run and
      downloads its checkpoint artifact, if any, into ``log_dir``.
    - Without ``wandb`` it raises ``ImportError``; ``optional=True`` makes
      it a no-op instead, with one warning on stderr.
    """

    def __init__(
        self,
        project: str = "tianshou_tpu_torch",
        name: str | None = None,
        config: dict | None = None,
        *,
        entity: str | None = None,
        resume_id: str | None = None,
        log_dir: str | None = None,
        optional: bool = False,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.wandb_run = None
        self.log_dir = log_dir
        try:
            import wandb
        except ImportError:
            if not optional:
                raise ImportError(
                    "WandbLogger requires the wandb package; pass optional=True to make it a no-op without it"
                ) from None
            print("WandbLogger: wandb not installed — logging disabled", file=sys.stderr)
            return
        self._wandb = wandb
        self.wandb_run = wandb.init(
            project=project,
            name=name,
            config=config,
            entity=entity,
            id=resume_id,
            resume="allow" if resume_id else None,
            dir=log_dir,
            reinit=True,
        )

    @property
    def run_id(self) -> str | None:
        return self.wandb_run.id if self.wandb_run is not None else None

    def write(self, step: int, data: dict[str, float]) -> None:
        if self.wandb_run is not None:
            self.wandb_run.log(data, step=step)

    def save_data(self, epoch, env_step, gradient_step, save_checkpoint_fn=None) -> None:
        ckpt_path = None
        if save_checkpoint_fn is not None:
            ckpt_path = save_checkpoint_fn(epoch, env_step, gradient_step)
        if self.wandb_run is None:
            return
        self.wandb_run.summary["save/epoch"] = int(epoch)
        self.wandb_run.summary["save/env_step"] = int(env_step)
        self.wandb_run.summary["save/gradient_step"] = int(gradient_step)
        if isinstance(ckpt_path, (str, bytes)) and os.path.exists(ckpt_path):
            art = self._wandb.Artifact(f"run_{self.wandb_run.id}_checkpoint", type="model")
            if os.path.isdir(ckpt_path):
                art.add_dir(ckpt_path)
            else:
                art.add_file(ckpt_path)
            self.wandb_run.log_artifact(art)

    def restore_data(self) -> tuple[int, int, int]:
        if self.wandb_run is None:
            return 0, 0, 0
        summary = self.wandb_run.summary
        epoch = int(summary.get("save/epoch", 0))
        env_step = int(summary.get("save/env_step", 0))
        grad_step = int(summary.get("save/gradient_step", 0))
        # a run without a checkpoint artifact resumes from its counters alone
        with contextlib.suppress(Exception):
            art = self.wandb_run.use_artifact(f"run_{self.wandb_run.id}_checkpoint:latest")
            art.download(self.log_dir or ".")
        self.last_log[DataScope.TRAIN] = env_step - 1
        self.last_log[DataScope.UPDATE] = grad_step - 1
        return epoch, env_step, grad_step

    def finalize(self) -> None:
        if self.wandb_run is not None:
            self.wandb_run.finish()
