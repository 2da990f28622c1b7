"""Sweep checkpoint / resume (port of ``tpu_ldpc/sim/state.py``).

The JSON schema is the JAX package's, so a checkpoint written by the JAX
sweep loads here: {"config_hash": str, "points": {snr_idx: {SnrResult
fields..., "batch_ctr": int}}}.  Because every batch's generator is
seeded from (seed, snr_idx, batch_ctr), a resumed run is bit-identical to
an uninterrupted one on the same device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile


class SweepState:
    """JSON-file-backed sweep state, committed atomically per step."""

    def __init__(self, path: str, config_hash: str = ""):
        self.path = path
        self.config_hash = config_hash
        self._points: dict[int, dict] = {}
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            if config_hash and data.get("config_hash", "") != config_hash:
                # strict on purpose: the hash covers the full config schema
                raise ValueError(
                    f"checkpoint {path} was written by a different config "
                    f"({data.get('config_hash')!r} != {config_hash!r}); "
                    "start fresh: delete the file or point --checkpoint "
                    "elsewhere (committed counters remain readable as JSON)"
                )
            self._points = {
                int(k): v for k, v in data.get("points", {}).items()
            }

    def load_point(self, snr_idx: int):
        """(SnrResult, batch_ctr) of a partially done point, or None."""
        from tpu_ldpc_torch.sim.mc import SnrResult

        p = self._points.get(snr_idx)
        if p is None:
            return None
        names = {f.name for f in dataclasses.fields(SnrResult)}
        res = SnrResult(**{k: v for k, v in p.items() if k in names})
        return res, int(p.get("batch_ctr", 0))

    def save_point(self, snr_idx: int, res, batch_ctr: int):
        d = dataclasses.asdict(res)
        d["batch_ctr"] = batch_ctr
        self._points[snr_idx] = d
        self._flush()

    def _flush(self):
        data = {"config_hash": self.config_hash, "points": self._points}
        # atomic replace so a mid-write crash can't corrupt the state
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(os.path.abspath(self.path)) or ".",
            suffix=".tmp",
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
