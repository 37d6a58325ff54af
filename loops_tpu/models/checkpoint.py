"""Checkpoint / resume for model and optimizer state.

The reference has no checkpointing (SURVEY.md §5 — its only persisted
artifacts are benchmark CSVs); params/opt-state pytrees are saved as
host numpy arrays in one pickle file.
"""
from __future__ import annotations

import pickle


def _file(path: str) -> str:
    return path if path.endswith(".pkl") else path + ".pkl"


def save(path: str, state) -> None:
    """Save a pytree (params, opt_state, step, ...) to ``path``."""
    import jax

    with open(_file(path), "wb") as f:
        pickle.dump(jax.device_get(state), f)


def restore(path: str, like=None):
    """Restore a pytree saved by :func:`save` (``like`` is accepted for
    API compatibility; the pickle carries its own structure)."""
    del like
    with open(_file(path), "rb") as f:
        return pickle.load(f)
