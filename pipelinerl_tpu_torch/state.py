"""Trainer-state messages and the listener used by every non-trainer stage.

Port of the JAX package's ``state.py`` with dataclasses in place of the
pydantic models (``model_dump`` is ``dataclasses.asdict``; the messages are
the same JSON). The trainer publishes ``WeightUpdateSuccess``,
``SamplesProcessed`` and ``TrainingDone`` on the ``weight_update_request``
topic; actors and preprocessors follow it on a daemon thread to track the
propagated weight version (= cumulative trained samples).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass

from .streams import SingleStreamSpec, StreamReader

TRAINER_TOPIC = "weight_update_request"


class _Message:
    def model_dump(self) -> dict:
        return dataclasses.asdict(self)


@dataclass(kw_only=True)
class WeightUpdateRequest(_Message):
    kind: str = "weight_update_request"
    version: int


@dataclass(kw_only=True)
class WeightUpdateSuccess(_Message):
    kind: str = "weight_update_success"
    version: int


@dataclass(kw_only=True)
class SamplesProcessed(_Message):
    kind: str = "samples_processed"
    samples: int


@dataclass(kw_only=True)
class TrainingDone(_Message):
    kind: str = "training_done"


_KINDS = {
    "weight_update_request": WeightUpdateRequest,
    "weight_update_success": WeightUpdateSuccess,
    "samples_processed": SamplesProcessed,
    "training_done": TrainingDone,
}


def parse_trainer_message(msg: dict):
    cls = _KINDS.get(msg.get("kind"))
    if cls is None:
        raise ValueError(f"Unknown trainer message kind: {msg.get('kind')!r}")
    return cls(**msg)


def trainer_state_spec(exp_path: str) -> SingleStreamSpec:
    return SingleStreamSpec(exp_path=exp_path, topic=TRAINER_TOPIC)


class TrainerState:
    """Tracks the trainer's progress as observed on the control stream."""

    def __init__(self, exp_path: str):
        self.exp_path = exp_path
        self.propagated_weight_version: int | None = None
        self.samples_processed: int = 0
        self.training_done: bool = False
        self._cond = threading.Condition()
        self._thread: threading.Thread | None = None
        self._reader: StreamReader | None = None

    def start_listening(self) -> None:
        assert self._thread is None
        self._reader = StreamReader(trainer_state_spec(self.exp_path))
        self._thread = threading.Thread(target=self._listen, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._reader is not None:
            self._reader.stop()

    def _listen(self) -> None:
        assert self._reader is not None
        for msg in self._reader.read():
            self.process_message(msg)
            if self.training_done:
                break

    def process_message(self, msg: dict) -> None:
        parsed = parse_trainer_message(msg)
        with self._cond:
            if isinstance(parsed, (WeightUpdateSuccess, WeightUpdateRequest)):
                if self.propagated_weight_version is None or parsed.version > self.propagated_weight_version:
                    self.propagated_weight_version = parsed.version
            elif isinstance(parsed, SamplesProcessed):
                self.samples_processed = max(self.samples_processed, parsed.samples)
            elif isinstance(parsed, TrainingDone):
                self.training_done = True
            self._cond.notify_all()

    def debug_mode_init(self) -> None:
        """Version 0 for a stage run without a trainer (``debug.mode``)."""
        with self._cond:
            self.propagated_weight_version = 0
            self._cond.notify_all()

    def wait_for_model_version(self, min_version: int = 0, timeout: float | None = None) -> int:
        """Block until the propagated version reaches ``min_version`` (or
        training is done); → the version."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self.propagated_weight_version is None or self.propagated_weight_version < min_version:
                if self.training_done:
                    break
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"Timed out waiting for weight version >= {min_version}")
                self._cond.wait(timeout=0.2 if remaining is None else min(0.2, remaining))
            return self.propagated_weight_version or 0
