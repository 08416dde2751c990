"""The port's errors: a pipeline error carrying its stage and details, and
the configuration, model-load, training, data and storage errors under it
(the JAX package's ``utils/exceptions.py`` but its ``InferenceError``,
which nothing in the port raises)."""

from __future__ import annotations

from typing import Any, Dict, Optional


class PipelineError(Exception):
    """Base error for pipeline failures, carrying stage and detail context."""

    def __init__(self, message: str, stage: Optional[str] = None, details: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.message = message
        self.stage = stage
        self.details = details or {}

    def __str__(self) -> str:
        parts = [self.message]
        if self.stage:
            parts.append(f"[stage: {self.stage}]")
        if self.details:
            parts.append("(" + ", ".join(f"{k}={v!r}" for k, v in self.details.items()) + ")")
        return " ".join(parts)


class ConfigurationError(PipelineError):
    """Invalid or missing configuration."""

    def __init__(self, message: str, **kw):
        super().__init__(message, stage="configuration", **kw)


class ModelLoadError(PipelineError):
    """Checkpoint discovery or restore failure."""

    def __init__(self, message: str, **kw):
        super().__init__(message, stage="model_load", **kw)


class TrainingError(PipelineError):
    """Training-loop failure."""

    def __init__(self, message: str, **kw):
        super().__init__(message, stage="training", **kw)


class DataError(PipelineError):
    """Dataset split, registration or parsing failure."""

    def __init__(self, message: str, **kw):
        super().__init__(message, stage="data", **kw)


class StorageError(PipelineError):
    """Remote or local artefact storage failure."""

    def __init__(self, message: str, **kw):
        super().__init__(message, stage="storage", **kw)
