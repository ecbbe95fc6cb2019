"""Step-stamped checkpoint / resume.

The reference has no checkpointing at all — a killed job reruns from scratch
(SURVEY.md section 5.3/5.4). Here snapshots carry the full distribution
state, the accumulated av_vels prefix and the parameter deck, so a run can
resume bitwise-identically at step k. Two storage backends:

- ``npz`` (default): one compressed file per snapshot, written atomically
  via rename; serialization happens on a writer thread (AsyncCheckpointer)
  so it overlaps the next compute chunk. Host-gathered — fine single-host.
- ``orbax``: an orbax-checkpoint directory per snapshot. The distribution
  state is saved as the (possibly sharded) jax array itself — on a
  multi-host mesh every process writes only its own shards (the
  analog of the reference's rank-ordered append, d2q9-bgk.c:1049-1122) and
  the save is natively asynchronous.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
from typing import Optional, Tuple

import numpy as np

from tpulbm.core.params import LBMParams

_NAME_RE = re.compile(r"ckpt_(\d+)\.npz$")
_ORBAX_RE = re.compile(r"ckpt_(\d+)\.orbax$")

BACKENDS = ("npz", "orbax")


def save(directory, step: int, f: np.ndarray, av_vels: np.ndarray,
         params: LBMParams, backend: str = "npz") -> str:
    if backend == "orbax":
        ckptr, path = _orbax_save_async(directory, step, f, av_vels, params)
        ckptr.wait_until_finished()
        ckptr.close()
        return path
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp,
        step=np.int64(step),
        f=np.asarray(f, dtype=np.float32),
        av_vels=np.asarray(av_vels, dtype=np.float32),
        params=json.dumps(dataclasses.asdict(params)),
    )
    os.replace(tmp, path)
    return path


def _orbax_save_async(directory, step, f, av_vels, params):
    """Starts an async orbax save; returns (checkpointer, path). The caller
    owns wait_until_finished()/close()."""
    import orbax.checkpoint as ocp

    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, f"ckpt_{step:08d}.orbax"))
    state = {
        "step": np.int64(step),
        "f": f,  # jax array passes through: sharded multi-host save
        "av_vels": np.asarray(av_vels, dtype=np.float32),
        "params": {k: v for k, v in dataclasses.asdict(params).items()},
    }
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, state, force=True)
    return ckptr, path


def _orbax_restore(path, abstract_f=None):
    """``abstract_f`` (a jax.ShapeDtypeStruct carrying a NamedSharding):
    restore the distribution state SHARDED — orbax places each shard
    directly onto its device (and, multi-host, each process reads only its
    own shards) with no host-side full-array materialization. The rest of
    the tree's abstract shapes come from the checkpoint's own metadata, so
    av_vels length variance (max_iters overrides) needs no special-casing."""
    import orbax.checkpoint as ocp
    from absl import logging as absl_logging

    # Target-less restore is intentional (av_vels length varies with
    # max_iters overrides); quiet absl's "UNSAFE without a target" warning.
    prev = absl_logging.get_verbosity()
    absl_logging.set_verbosity(absl_logging.ERROR)
    try:
        with ocp.PyTreeCheckpointer() as ckptr:
            apath = os.path.abspath(path)
            state = None
            if abstract_f is not None:
                # Per-leaf restore args: ``f`` carries a sharding, so orbax
                # loads each shard straight onto its device (multi-host:
                # each process reads only its own shards) with no host
                # full-array materialization; the small leaves restore as
                # host numpy with shapes from the checkpoint itself (so
                # av_vels length variance needs no special-casing).
                import jax

                ra = ocp.RestoreArgs()
                restore_args = {
                    "step": ra,
                    "av_vels": ra,
                    "params": {
                        k: ra
                        for k in LBMParams.__dataclass_fields__
                    },
                    "f": ocp.ArrayRestoreArgs(
                        restore_type=jax.Array,
                        sharding=abstract_f.sharding,
                        global_shape=tuple(abstract_f.shape),
                        dtype=abstract_f.dtype,
                    ),
                }
                try:
                    state = ckptr.restore(
                        apath,
                        args=ocp.args.PyTreeRestore(
                            restore_args=restore_args
                        ),
                    )
                except (ValueError, KeyError) as e:
                    # ONLY a tree-schema mismatch (e.g. a checkpoint written
                    # by an older params schema — orbax raises ValueError
                    # "Dict key mismatch ..." / KeyError) downgrades to the
                    # host-gathered target-less restore below, loudly. Any
                    # other failure (corrupt shard, I/O error, wrong mesh)
                    # propagates: silently host-gathering a huge state on a
                    # real multi-host run is a failure mode, not a fallback.
                    import sys

                    print(
                        "warning: sharded orbax restore failed with a "
                        f"schema mismatch ({type(e).__name__}: {e}); "
                        "falling back to the host-gathered restore path",
                        file=sys.stderr,
                    )
                    state = None
            if state is None:
                abstract_f = None
                state = ckptr.restore(apath)
    finally:
        absl_logging.set_verbosity(prev)
    f = state["f"]
    if abstract_f is None:
        f = np.asarray(f, dtype=np.float32)
    return (
        int(state["step"]),
        f,
        np.asarray(state["av_vels"], dtype=np.float32),
        {k: _pyscalar(v) for k, v in state["params"].items()},
    )


def _pyscalar(v):
    v = np.asarray(v).item() if np.ndim(v) == 0 else v
    return v


class AsyncCheckpointer:
    """Overlaps checkpoint serialization with the next compute chunk:
    ``submit`` hands off the write (a writer thread for npz; orbax's native
    async machinery for orbax); ``wait`` joins the in-flight write (called
    before the next submit and at shutdown). At most one write is in flight —
    a second submit first waits for the previous one, so checkpoints are
    never reordered."""

    def __init__(self, backend: str = "npz"):
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown checkpoint backend {backend!r} (choose from {BACKENDS})"
            )
        self.backend = backend
        self._thread: Optional[threading.Thread] = None
        self._orbax = None
        self._result: Optional[str] = None
        self._error: Optional[BaseException] = None

    def submit(self, directory, step, f, av_vels, params) -> None:
        self.wait()
        if self.backend == "orbax":
            self._orbax, self._result = _orbax_save_async(
                directory, step, f, np.array(av_vels, copy=True), params
            )
            return
        f = np.asarray(f)
        av_vels = np.array(av_vels, copy=True)

        def work():
            try:
                self._result = save(directory, step, f, av_vels, params)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> Optional[str]:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._orbax is not None:
            ckptr, self._orbax = self._orbax, None
            try:
                ckptr.wait_until_finished()
            finally:
                ckptr.close()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        return self._result


def latest(directory) -> str | None:
    if not os.path.isdir(directory):
        return None
    best = None
    best_step = -1
    for name in os.listdir(directory):
        m = _NAME_RE.match(name) or _ORBAX_RE.match(name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(directory, name)
    return best


def restore(
    path_or_dir, params: LBMParams, abstract_f=None
) -> Tuple[int, np.ndarray, np.ndarray]:
    """``abstract_f`` (optional jax.ShapeDtypeStruct with a sharding) makes
    an orbax restore sharding-aware — ``f`` comes back as a sharded jax
    array placed straight onto the mesh (npz checkpoints ignore it: they are
    host-gathered by construction)."""
    path = str(path_or_dir)
    if os.path.isdir(path) and not _ORBAX_RE.search(os.path.basename(path)):
        path = latest(path)
        if path is None:
            raise FileNotFoundError(f"no checkpoints under {path_or_dir}")
    if _ORBAX_RE.search(os.path.basename(path)):
        step, f, av_vels, saved = _orbax_restore(path, abstract_f=abstract_f)
    else:
        with np.load(path, allow_pickle=False) as z:
            step = int(z["step"])
            f = z["f"]
            av_vels = z["av_vels"]
            saved = json.loads(str(z["params"]))
    current = dataclasses.asdict(params)
    mismatched = {
        k: (saved[k], current[k])
        for k in saved
        # free_cells_inv depends on the obstacle file, checked via the grid;
        # max_iters may legitimately be overridden between sessions.
        if k not in ("free_cells_inv", "max_iters") and saved[k] != current[k]
    }
    if mismatched:
        detail = ", ".join(
            f"{k}: checkpoint={a!r} vs current={b!r}"
            for k, (a, b) in sorted(mismatched.items())
        )
        raise ValueError(f"checkpoint params do not match the deck ({detail})")
    return step, f, av_vels
