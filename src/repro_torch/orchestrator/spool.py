"""The shared spool directory: the only channel between daemon and workers.

Workers and the daemon never share memory — everything crosses a plain
directory of JSON files, written atomically (temp file + ``os.replace``)
so a reader can never observe a torn write. The layout and the JSON are
the reference's (``repro.orchestrator.spool``): either package reads a
spool the other wrote. This is the shepherd idiom
(SNIPPETS.md snippet 1: compute-side wrapper drops heartbeat/final
markers; the login-side daemon polls them) mapped onto one host.

Layout under the spool root::

    workers/<wid>/hb.json      worker -> daemon: heartbeat + progress
    workers/<wid>/cmd.json     daemon -> worker: sequenced command
    workers/<wid>/final.json   worker -> daemon: death certificate
    ckpt/shard_<k>.json        owning worker: shard checkpoint
    result/shard_<k>.json      owning worker: final shard output
    daemon.json                daemon: live status (the ``status`` CLI)

Commands are sequenced (``seq`` strictly increasing per worker); a
worker acts on a command exactly once by tracking the last seq it
consumed, so the daemon can overwrite ``cmd.json`` freely.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional


def _write_json(path: str, payload: Dict) -> None:
    """Atomic JSON write: readers see the old file or the new, never half."""
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_", suffix=".json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _read_json(path: str) -> Optional[Dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None  # missing, or a reader raced a non-atomic external write


class Spool:
    """One campaign's spool directory, shared by daemon and workers."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------- paths ---
    def worker_dir(self, wid: int) -> str:
        return os.path.join(self.root, "workers", str(int(wid)))

    def _hb(self, wid: int) -> str:
        return os.path.join(self.worker_dir(wid), "hb.json")

    def _cmd(self, wid: int) -> str:
        return os.path.join(self.worker_dir(wid), "cmd.json")

    def _final(self, wid: int) -> str:
        return os.path.join(self.worker_dir(wid), "final.json")

    def _ckpt(self, shard: int) -> str:
        return os.path.join(self.root, "ckpt", f"shard_{int(shard)}.json")

    def _result(self, shard: int) -> str:
        return os.path.join(self.root, "result", f"shard_{int(shard)}.json")

    def _status(self) -> str:
        return os.path.join(self.root, "daemon.json")

    # ------------------------------------------------------- worker side ---
    def write_heartbeat(self, wid: int, payload: Dict) -> None:
        _write_json(self._hb(wid), payload)

    def write_final(self, wid: int, payload: Dict) -> None:
        _write_json(self._final(wid), payload)

    def read_command(self, wid: int) -> Optional[Dict]:
        return _read_json(self._cmd(wid))

    def write_checkpoint(self, shard: int, payload: Dict) -> None:
        _write_json(self._ckpt(shard), payload)

    def read_checkpoint(self, shard: int) -> Optional[Dict]:
        return _read_json(self._ckpt(shard))

    def write_result(self, shard: int, payload: Dict) -> None:
        _write_json(self._result(shard), payload)

    # ------------------------------------------------------- daemon side ---
    def read_heartbeat(self, wid: int) -> Optional[Dict]:
        return _read_json(self._hb(wid))

    def read_final(self, wid: int) -> Optional[Dict]:
        return _read_json(self._final(wid))

    def send_command(self, wid: int, payload: Dict, seq: int) -> None:
        _write_json(self._cmd(wid), dict(payload, seq=int(seq)))

    def read_result(self, shard: int) -> Optional[Dict]:
        return _read_json(self._result(shard))

    def results(self, n_shards: int) -> Dict[int, Dict]:
        out: Dict[int, Dict] = {}
        for k in range(n_shards):
            r = self.read_result(k)
            if r is not None:
                out[k] = r
        return out

    def write_status(self, payload: Dict) -> None:
        _write_json(self._status(), payload)

    def read_status(self) -> Optional[Dict]:
        return _read_json(self._status())
