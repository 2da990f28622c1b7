"""Config system (port of ``tpu_ldpc/cli/config.py``): frozen dataclasses,
JSON + dotted CLI overrides, a provenance hash stamped into every CSV and
checkpoint.

It builds the judged, wifi, wimax, alist and sc codes.  The NR-like
families need the puncturing of ``channel/adapt.py`` and raise; the
channel has no rate adaptation and no CRC yet (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Sequence

from tpu_ldpc_torch.sim.mc import DecodeCfg


@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """Which code to build: a registry family cell, an SC chain, an
    alist import, or the judged code."""

    family: str = "judged"   # 'judged' | 'wifi' | 'wimax' | 'sc' | 'alist'
    rate: str = "1/2"
    Z: int = 64
    path: str = ""           # for family='alist'
    L: int = 32              # chain length, for family='sc'

    def build(self):
        from tpu_ldpc_torch.codes.code import LdpcCode

        if self.family == "judged":
            return LdpcCode.judged()
        if self.family in ("nr", "nr2"):
            raise NotImplementedError(
                f"family={self.family!r} needs rate adaptation "
                "(channel/adapt.py), not ported yet (ROADMAP Queue 1 item 6)"
            )
        if self.family == "alist":
            from tpu_ldpc_torch.codes.alist import load_alist

            return load_alist(self.path)
        if self.family == "sc":
            from tpu_ldpc_torch.codes.base_graphs import make_sc_base_graph

            return LdpcCode.from_base_graph(
                make_sc_base_graph(self.L, self.Z),
                self.Z, f"sc_l{self.L}_z{self.Z}",
            )
        return LdpcCode.from_family(self.family, self.rate, self.Z)


@dataclasses.dataclass(frozen=True)
class ChannelCfg:
    ebn0_grid: tuple = (1.0, 1.5, 2.0, 2.5, 3.0)


@dataclasses.dataclass(frozen=True)
class RunCfg:
    batch: int = 256
    target_frame_errors: int = 100
    max_frames: int = 1_000_000
    seed: int = 0
    state_path: str = ""     # checkpoint file; empty = no checkpointing
    out_csv: str = ""
    jsonl: str = ""          # structured per-point records
    step_jsonl: str = ""     # per-call observability records
    device: str = "cuda"     # 'cuda' raises without a card; 'cpu' is explicit


@dataclasses.dataclass(frozen=True)
class SimConfig:
    code: CodeSpec = CodeSpec()
    decode: DecodeCfg = DecodeCfg()
    channel: ChannelCfg = ChannelCfg()
    run: RunCfg = RunCfg()

    def config_hash(self) -> str:
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    @staticmethod
    def from_sources(json_path: str | None = None,
                     overrides: Sequence[str] = ()) -> "SimConfig":
        """JSON file + dotted CLI overrides like 'decode.alpha=0.8'."""
        data: dict = {}
        if json_path:
            with open(json_path) as f:
                data = json.load(f)
        for ov in overrides:
            key, _, val = ov.partition("=")
            parts = key.strip().split(".")
            d = data
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = json.loads(val) if _looks_jsonish(val) else val
        return _build_config(data)


def _looks_jsonish(v: str) -> bool:
    v = v.strip()
    if v and (v[0] in '[{"0123456789-' or v in ("true", "false", "null")):
        return True
    try:
        float(v)
        return True
    except ValueError:
        return False


def _build_config(data: dict) -> SimConfig:
    def sub(cls, d):
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in (d or {}).items():
            if k not in fields:
                raise ValueError(
                    f"unknown config key {k!r} for {cls.__name__}; "
                    f"valid: {sorted(fields)}"
                )
            if fields[k].type in ("tuple", tuple) or isinstance(v, list):
                v = tuple(v)
            kw[k] = v
        return cls(**kw)

    return SimConfig(
        code=sub(CodeSpec, data.get("code")),
        decode=sub(DecodeCfg, data.get("decode")),
        channel=sub(ChannelCfg, data.get("channel")),
        run=sub(RunCfg, data.get("run")),
    )
