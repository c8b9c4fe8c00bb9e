"""Global exception hook — failure containment.

Port of ``chainermn_tpu/global_except_hook.py`` (reference: ChainerMN's
``global_except_hook``, which calls ``MPI_Abort`` from ``sys.excepthook``).
There is no ``MPI_Abort`` over ``torch.distributed``: the hook makes the
failing rank print a postmortem (its rank in the banner, the traceback)
and leave at once with ``os._exit``, so no atexit handler or process-group
teardown can hang it; its peers' next collective then fails on the closed
connection (or a barrier's timeout) instead of waiting forever.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

_EXIT_CODE = 13  # distinct from the interpreter's 1: "left by the hook"
_hook_installed = False


def _safe_rank():
    """(rank, world size) without touching a backend: -1, -1 when no
    process group is up."""
    dist = sys.modules.get("torch.distributed")
    try:
        if dist is not None and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
    except Exception:  # noqa: BLE001 — the hook must not raise
        pass
    return -1, -1


def _write_postmortem(rank, size, exc_type, exc_value, exc_traceback):
    """Append one JSON crash row to ``CHAINERMN_TPU_POSTMORTEM_FILE`` when
    it is set (O_APPEND, so concurrent ranks do not tear each other's
    lines).  Never raises: a failing postmortem must not mask the exit."""
    path = os.environ.get("CHAINERMN_TPU_POSTMORTEM_FILE")
    if not path:
        return
    tb = "".join(
        traceback.format_exception(exc_type, exc_value, exc_traceback)
    )[-8000:]
    row = {"event": "crash", "rank": rank, "size": size, "t": time.time(),
           "exc": f"{exc_type.__name__}: {exc_value}", "traceback": tb}
    try:
        fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
        try:
            os.write(fd, (json.dumps(row) + "\n").encode("utf-8"))
        finally:
            os.close(fd)
    except OSError:
        pass


def _handle_uncaught(exc_type, exc_value, exc_traceback):
    rank, size = _safe_rank()
    sys.stderr.write(
        "\n*****************************************************\n"
        f"chainermn_tpu_torch: uncaught exception on rank {rank}/{size};\n"
        "leaving this process so its peers fail fast instead of hanging\n"
        "in a collective.\n"
        "*****************************************************\n"
    )
    traceback.print_exception(exc_type, exc_value, exc_traceback)
    _write_postmortem(rank, size, exc_type, exc_value, exc_traceback)
    sys.stderr.flush()
    sys.stdout.flush()
    os._exit(_EXIT_CODE)


def add_hook():
    """Install the hook (idempotent)."""
    global _hook_installed
    if not _hook_installed:
        sys.excepthook = _handle_uncaught
        _hook_installed = True


def remove_hook():
    global _hook_installed
    sys.excepthook = sys.__excepthook__
    _hook_installed = False
