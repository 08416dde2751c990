"""The errors the configuration store raises: a pipeline error carrying its
stage and details, and the configuration error under it (the JAX package's
``utils/exceptions.py``, the part the store needs)."""

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
