"""Checkpoint/resume helpers: the port of ``horovod_tpu/utils/checkpoint.py``.

The reference has no checkpointing in its core — the supported pattern
is rank-0-writes + broadcast-on-start (SURVEY §5:
``broadcast_parameters`` / ``broadcast_optimizer_state``; examples gate
their checkpoint writes on rank 0).  This module packages that pattern:

    save_checkpoint(path, state, step=n)          # rank 0 writes
    state = restore_checkpoint(path, state)       # all load + broadcast

The ``step_N`` + ``step_N.COMMITTED`` protocol is the reference's, name
for name: the sentinel is written next to ``step_N`` only after the save
finished, an overwrite clears it first, and :func:`latest_step` skips
every directory without one, so a torn write is never resumed from.

What differs (ROADMAP "Decisions"): the content of ``step_N`` is the
port's own format, not orbax (a JAX library the port does not depend
on): one ``state.pt`` written by ``torch.save`` with every tensor on the
CPU (bfloat16 stays bfloat16), first under a temporary name and then
renamed.  ``restore_checkpoint`` loads it into the tensors of ``like``
in place (``load_into``), so a train step captured against those tensors
keeps working.  Directories are listed with ``os.listdir`` and files
written with ``open`` (the port does not depend on ``fsspec``): local
and mounted paths only.

``restore_checkpoint`` finishes with the reference's broadcast agreement
(reference ``:181-234``): every rank reports whether its read worked;
when all did, rank 0's tensors are broadcast in place
(``broadcast_parameters``); when only rank 0's did, its whole tree is
shipped by ``broadcast_object``; a rank-0 failure raises on every rank.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from .. import core

#: Commit sentinel written NEXT TO a ``step_N`` dir (``step_N.COMMITTED``)
#: after a successful save — a sibling, not inside the dir.
#: ``latest_step`` only considers committed dirs, so a rank-0 crash
#: mid-save can never be resumed from a torn checkpoint.
COMMIT_MARKER_SUFFIX = ".COMMITTED"

#: the one file of a ``step_N`` directory
STATE_FILE = "state.pt"


def _flight_event(kind: str, payload: dict,
                  cause_id: Optional[str] = None) -> Optional[str]:
    """Best-effort flight-recorder emit (observe/events.py) — a
    telemetry failure must never take down a save or restore."""
    try:
        from ..observe import events as events_mod

        return events_mod.record_event(kind, severity="info",
                                       payload=payload, cause_id=cause_id)
    except Exception:  # noqa: BLE001
        return None


# ---------------------------------------------------------------------------
# trees: namedtuples, dicts, lists and tuples of tensors, arrays and scalars
# ---------------------------------------------------------------------------
def tree_map(fn, tree):
    """``fn`` over every leaf, the containers rebuilt (namedtuples as
    their own type, dicts with their keys sorted, as ``jax.tree_util``
    rebuilds them: the reference's pickles of a tree see that order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def to_cpu(tree):
    """``tree`` with every tensor copied to the CPU (dtype kept)."""
    return tree_map(lambda t: t.detach().cpu() if torch.is_tensor(t) else t,
                    tree)


def to_numpy(tree):
    """``tree`` with every tensor as a numpy array on the host: the
    wire form both packages read.  numpy has no bfloat16 here, so a
    bfloat16 (or other non-numpy) tensor travels as float32, which holds
    it exactly; :func:`load_into` casts it back to its tensor's dtype.
    A numpy scalar becomes a 0-d array, as ``jax.device_get`` makes it,
    so one state pickles to the reference's bytes."""
    def leaf(t):
        if isinstance(t, np.generic):
            return np.asarray(t)
        if not torch.is_tensor(t):
            return t
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(leaf, tree)


def load_into(like, loaded):
    """``loaded``'s values in ``like``'s structure: each tensor of
    ``like`` takes its counterpart's values in place (any device, cast
    to its dtype), every other leaf is ``loaded``'s.  A structure that
    differs raises ``ValueError``."""
    if isinstance(like, dict):
        if not isinstance(loaded, dict) or set(like) != set(loaded):
            got = sorted(loaded) if isinstance(loaded, dict) \
                else type(loaded).__name__
            raise ValueError(f"checkpoint keys {got} do not match the "
                             f"state's {sorted(like)}")
        return {k: load_into(like[k], loaded[k]) for k in like}
    if isinstance(like, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) or len(like) != len(loaded):
            raise ValueError(f"checkpoint has {loaded!r:.80} where the state "
                             f"has a sequence of {len(like)}")
        vals = [load_into(a, b) for a, b in zip(like, loaded)]
        if hasattr(like, "_fields"):
            return type(like)(*vals)
        return type(like)(vals)
    if torch.is_tensor(like):
        src = loaded if torch.is_tensor(loaded) \
            else torch.as_tensor(np.asarray(loaded))
        if tuple(src.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf of shape {tuple(src.shape)} "
                             f"for a tensor of {tuple(like.shape)}")
        with torch.no_grad():
            like.copy_(src)
        return like
    return loaded


# ---------------------------------------------------------------------------
# the commit protocol
# ---------------------------------------------------------------------------
def commit_marker_path(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step}{COMMIT_MARKER_SUFFIX}")


def write_commit_marker(path: str, step: int) -> None:
    """Stamp ``step_{step}`` as fully written."""
    with open(commit_marker_path(path, step), "wb") as f:
        f.write(b"1")


def clear_commit_marker(path: str, step: int) -> None:
    """Best-effort removal of the sentinel (the un-commit half of an
    overwrite)."""
    try:
        os.remove(commit_marker_path(path, step))
    except FileNotFoundError:
        pass


def is_committed(path: str, step: int) -> bool:
    """True when ``step_{step}`` under ``path`` carries the commit
    sentinel (a save that ran to completion)."""
    return os.path.exists(commit_marker_path(path, step))


def save_checkpoint(path: str, state: Any, *, step: Optional[int] = None,
                    force: bool = True) -> Optional[str]:
    """Write ``state`` (any tree of tensors, arrays and scalars) from the
    root process only (reference idiom: rank-0-gated checkpoint writes).
    Returns the written path on the root, None elsewhere.

    Step saves are committed for crash safety: the ``COMMITTED``
    sentinel is written only after the file is in place, an overwrite
    clears it first, and ``latest_step`` ignores uncommitted dirs.
    ``force=False`` refuses to overwrite an existing file."""
    target = os.path.join(path, f"step_{step}") if step is not None else path
    if core.is_initialized() and core.process_rank() != 0:
        return None
    host = to_cpu(state)
    file = os.path.join(target, STATE_FILE)
    if not force and os.path.exists(file):
        raise FileExistsError(f"checkpoint {file} exists (force=False)")
    if step is not None:
        # proper commit protocol on overwrite: un-commit first, so a
        # crash while the file is rewritten leaves it uncommitted too
        clear_commit_marker(path, step)
    save_eid = _flight_event("checkpoint.save",
                             {"path": target, "step": step})
    os.makedirs(target, exist_ok=True)
    tmp = f"{file}.{os.getpid()}.tmp"
    torch.save(host, tmp)
    os.replace(tmp, file)
    if step is not None:
        write_commit_marker(path, step)
        _flight_event("checkpoint.commit",
                      {"path": target, "step": step}, cause_id=save_eid)
    return target


def latest_step(path: str) -> Optional[int]:
    """Largest *committed* ``step_N`` under ``path`` (None if none).
    Dirs without the ``COMMITTED`` sentinel are torn writes (the saver
    died mid-save) and are skipped — resuming from one would load a
    checkpoint that never finished."""
    try:
        names = os.listdir(path)
    except (FileNotFoundError, NotADirectoryError):
        return None
    steps = [int(d[len("step_"):]) for d in names
             if d.startswith("step_") and d[len("step_"):].isdigit()]
    name_set = set(names)
    committed = [s for s in steps
                 if f"step_{s}{COMMIT_MARKER_SUFFIX}" in name_set]
    if steps and not committed:
        from .logging import get_logger

        get_logger(__name__).warning(
            "checkpoint dir %s has step dirs %s but no %s sentinels — "
            "they are either torn writes or pre-commit-marker "
            "checkpoints; refusing to resume from them (touch "
            "step_N%s to bless a checkpoint you trust)",
            path, sorted(steps), COMMIT_MARKER_SUFFIX.lstrip("."),
            COMMIT_MARKER_SUFFIX,
        )
    return max(committed) if committed else None


def _read(target: str):
    return torch.load(os.path.join(target, STATE_FILE), map_location="cpu",
                      weights_only=False)


def restore_checkpoint(path: str, like: Any, *, step: Optional[int] = None,
                       broadcast: bool = True) -> Any:
    """Load the tree stored at ``path`` (or its ``step_N`` subdir) into
    ``like`` (its tensors in place: :func:`load_into`), then make every
    process hold rank 0's values (the reference's broadcast-on-start
    resume contract).

    Multi-process: only rank 0 is required to see ``path`` — when a
    non-root read fails (no shared filesystem), root's restored tree is
    shipped whole via ``broadcast_object``; when every rank could read,
    root's tensors are broadcast in place (``broadcast_parameters``)."""
    multi = core.is_initialized() and core.process_size() > 1
    if step is None:
        step = latest_step(path)
        if multi:  # rank-consistent choice even if only root sees the dir
            from .. import eager

            step = eager.broadcast_object(step)
    target = os.path.join(path, f"step_{step}") if step is not None else path
    _flight_event("checkpoint.restore", {"path": target, "step": step})

    err: Optional[Exception] = None
    restored = None
    try:
        restored = load_into(like, _read(target))
    except Exception as e:  # noqa: BLE001
        if not (multi and broadcast):
            raise
        err = e  # held until the agreement round, so no rank is stranded

    if broadcast and multi:
        from .. import eager

        # Every rank must pick the SAME collective, and a root failure
        # must surface on every rank (raising before the agreement would
        # leave the others blocked until timeout with no root cause).
        statuses = eager.allgather_object(
            None if restored is not None else repr(err))
        if statuses[0] is not None:
            raise RuntimeError(
                f"rank 0 failed to restore {target!r}: {statuses[0]}")
        if all(s is None for s in statuses):
            from ..optim.distributed import broadcast_parameters

            restored = broadcast_parameters(restored)
        else:
            root = eager.broadcast_object(
                to_cpu(restored) if core.process_rank() == 0 else None)
            restored = load_into(like, root)
    elif err is not None:
        raise err
    return restored
