"""Config system (port of ``tpu_ldpc/cli/config.py``): frozen dataclasses,
JSON + dotted CLI overrides, a provenance hash stamped into every CSV and
checkpoint.

It builds the judged, wifi, wimax, NR-like (nr, nr2), alist and sc
codes; the channel section carries rate adaptation (puncturing and
shortening, ``channel/adapt.py``) and the outer CRC (``codes/crc.py``).
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

    # 'judged' | 'wifi' | 'wimax' | 'nr' | 'nr2' | 'sc' | 'alist'
    family: str = "judged"
    rate: str = "1/2"
    Z: int = 64
    path: str = ""           # for family='alist'
    L: int = 32              # chain length, for family='sc'

    def build(self):
        from tpu_ldpc_torch.codes.code import LdpcCode

        if self.family == "judged":
            return LdpcCode.judged()
        if self.family in ("nr", "nr2"):
            # NR-like rate-compatible families (codes/nrlike.py): 'nr' =
            # BG1-like (kb=22, rates 1/2..5/6), 'nr2' = BG2-like (kb=10,
            # rates down to 1/5); ChannelCfg.build_adapt punctures their
            # first two systematic blocks by default
            from tpu_ldpc_torch.codes.nrlike import nrlike_code

            return nrlike_code(self.rate, self.Z,
                               bg=2 if self.family == "nr2" else 1)
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
    # rate adaptation (channel/adapt.py): block-columns of the mother
    # code to puncture (any block) / shorten (info blocks only)
    puncture_blocks: tuple = ()
    shorten_blocks: tuple = ()
    # outer CRC (codes/crc.py name, e.g. "crc24"): attached to the info
    # block; it gates the detected / undetected counters (sim/mc.py)
    crc: str | None = None

    def build_adapt(self, code):
        """RateAdapt for this config, or None when not adapted.

        NR-like registry cells default to their family's contract (the
        two high-degree systematic blocks are never transmitted) unless
        the config names an adaptation."""
        if not self.puncture_blocks and not self.shorten_blocks:
            import re

            # exact registry-cell names only (nr1_r12_z64 etc.): the HARQ
            # stage codes (nr1_m24_z64) and user codes whose names merely
            # start with the prefix are not punctured
            if re.fullmatch(r"nr[12]_r\d+_z\d+", code.name):
                from tpu_ldpc_torch.codes.nrlike import nrlike_adapt

                return nrlike_adapt(code)
            return None
        from tpu_ldpc_torch.channel.adapt import RateAdapt

        return RateAdapt.from_blocks(
            code,
            puncture_blocks=self.puncture_blocks,
            shorten_blocks=self.shorten_blocks,
        )


@dataclasses.dataclass(frozen=True)
class RunCfg:
    batch: int = 256
    target_frame_errors: int = 100
    max_frames: int = 1_000_000
    seed: int = 0
    use_mesh: bool = False   # sweep over the ranks of the process group
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
