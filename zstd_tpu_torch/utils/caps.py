"""Runtime override of the chained/far-path size caps.

The production caps (framer.GROUP_OUT_CAP, framer.GROUP_SEQ_CAP,
framer.STREAM_WINDOW_CAP, ops/tables.WINDOW_VMEM_CAP) split frames into
block groups of about 2 MiB and put the near/far line at an 8 MiB window.
The CPU tests shrink every cap so that chained, far-window and
dictionary-prefill frames run through the same code paths at KiB sizes.
The environment variables carry the reference package's names, so one
setting frames a batch the same way in both packages; non-default group
caps force the framer's Python walk (framer.py, _walk_native).

All caps are env-overridable at import (ZSTD_TPU_GROUP_OUT_CAP etc.);
set_caps() additionally patches the already-imported modules so an
in-process caller (pytest) works too.
"""

import os
import sys

# (env var, module, attr) for every cap and each import-time copy of it
_SITES = {
    "group_out": [("ZSTD_TPU_GROUP_OUT_CAP",
                   "zstd_tpu_torch.models.framer", "GROUP_OUT_CAP")],
    "group_seq": [("ZSTD_TPU_GROUP_SEQ_CAP",
                   "zstd_tpu_torch.models.framer", "GROUP_SEQ_CAP")],
    "stream_window": [("ZSTD_TPU_STREAM_WINDOW_CAP",
                       "zstd_tpu_torch.models.framer", "STREAM_WINDOW_CAP")],
    "window_vmem": [("ZSTD_TPU_WINDOW_VMEM_CAP",
                     "zstd_tpu_torch.ops.tables", "WINDOW_VMEM_CAP"),
                    ("ZSTD_TPU_WINDOW_VMEM_CAP",
                     "zstd_tpu_torch.models.framer", "WINDOW_VMEM_CAP")],
}

DEFAULTS = dict(group_out=(1 << 21) - (1 << 17), group_seq=80 * 1024,
                stream_window=1 << 23, window_vmem=1 << 22)
TINY = dict(group_out=1 << 15, group_seq=3 * 1024,
            stream_window=1 << 16, window_vmem=1 << 14)


def set_caps(**caps) -> dict:
    """Set caps by name (see TINY for the names); returns the previous
    values for restore_caps(). Patches env (for not-yet-imported modules)
    and every already-imported copy."""
    old = {}
    for name, value in caps.items():
        for env, modname, attr in _SITES[name]:
            old.setdefault(name, os.environ.get(env))
            os.environ[env] = str(int(value))
            mod = sys.modules.get(modname)
            if mod is not None:
                setattr(mod, attr, int(value))
    return old


def restore_caps(old: dict) -> None:
    for name, env_val in old.items():
        for env, modname, attr in _SITES[name]:
            if env_val is None:
                os.environ.pop(env, None)
                value = DEFAULTS[name]
            else:
                os.environ[env] = env_val
                value = int(env_val)
            mod = sys.modules.get(modname)
            if mod is not None:
                setattr(mod, attr, value)


class tiny_caps:
    """Context manager applying the TINY cap set (CPU testing)."""

    def __init__(self, **over):
        self.caps = dict(TINY, **over)

    def __enter__(self):
        self.old = set_caps(**self.caps)
        return self

    def __exit__(self, *exc):
        restore_caps(self.old)
        return False
