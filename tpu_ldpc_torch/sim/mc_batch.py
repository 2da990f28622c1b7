"""The Monte-Carlo batch's kernels around the decoder
(``csrc/mc_batch.cu``): ``mc_encode_llr`` (u, noise) -> LLRs, the
encoder and the channel in one pass, and ``mc_count`` (bits, u, passed,
iters_used) -> the six counters added into an int64 (6,) tensor.

``sim/mc.py::BatchFn`` takes them for every batch on the card (the
generator and the pivot encoder, with or without ``RateAdapt``, with or
without a CRC) and runs its PyTorch ops on the CPU, which are the
kernels' plain version.  ``BatchKernels`` holds one
BatchFn's host-built tables on its device: the parity map packed into
32-bit words (``pack_parity_table``), the pivot encoder's column map
(``position_map``) and the RateAdapt masks.  A launch on a tensor that
is not on the card raises; there is no fallback.

Each launch adds one to ``LAUNCHES[name]``; ``reset_launches()`` sets
them to 0.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ldpc_torch.channel.awgn import llr_constants

LAUNCHES: dict[str, int] = {"mc_encode_llr": 0, "mc_count": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def table_dims(k: int, m: int) -> tuple[int, int]:
    """(kwp, mp) of the packed table of a (m, k) parity map: words per
    column padded to a multiple of 4, columns to a multiple of 32."""
    kw = -(-k // 32)
    return -(-kw // 4) * 4, -(-m // 32) * 32


def pack_parity_table(M: np.ndarray) -> np.ndarray:
    """(kwp, mp) uint32 table of the (m, k) 0/1 parity map M: word w of
    parity column r holds M[r, 32w + b] at bit b; zero padding."""
    m, k = M.shape
    kwp, mp = table_dims(k, m)
    bits = np.zeros((mp, kwp * 32), dtype=np.uint8)
    bits[:m, :k] = M
    words = np.packbits(bits.reshape(mp, kwp, 32), axis=-1,
                        bitorder="little").view("<u4")
    return np.ascontiguousarray(words.reshape(mp, kwp).T.astype(np.uint32))


def position_map(n: int, info_cols, parity_cols) -> np.ndarray:
    """(n,) int32: the index in [u | p] of each codeword position, for an
    encoder that puts info bit i at info_cols[i] and parity bit r at
    parity_cols[r]."""
    pos = np.empty(n, dtype=np.int64)
    pos[np.asarray(info_cols)] = np.arange(len(info_cols))
    pos[np.asarray(parity_cols)] = len(info_cols) + np.arange(
        len(parity_cols))
    return pos.astype(np.int32)


def _ptr(t):
    return None if t is None else t.data_ptr()


class BatchKernels:
    """Kernels A and B of one BatchFn (its encoder, payload length and
    masks), with their tables on the BatchFn's device."""

    def __init__(self, encode_fn, n: int, kp: int, device: torch.device,
                 tx_mask=None, known_llr=None, active_u=None):
        M = np.asarray(encode_fn.parity_M, dtype=np.uint8)
        self.n, self.k, self.kp = n, M.shape[1], kp
        self.table = torch.from_numpy(pack_parity_table(M).view(
            np.int32)).to(device)
        self.pos = self.info_cols = None
        if encode_fn.info_cols is not None:
            self.pos = torch.from_numpy(position_map(
                n, encode_fn.info_cols, encode_fn.parity_cols)).to(device)
            self.info_cols = torch.as_tensor(
                np.asarray(encode_fn.info_cols, dtype=np.int32)).to(device)
        self.tx_mask, self.known_llr = tx_mask, known_llr
        self.active_u = active_u

    @classmethod
    def of(cls, batch_fn) -> "BatchKernels":
        """The kernels of a ``sim/mc.py::BatchFn``, on its device."""
        return cls(batch_fn.encode_fn, batch_fn.n, batch_fn.kp,
                   batch_fn.device, batch_fn.tx_mask, batch_fn.known_llr,
                   batch_fn.active_u)

    @staticmethod
    def _lib():
        from tpu_ldpc_torch._build import load_library

        return load_library("mc_batch")

    def _check_u(self, u):
        if u.device.type != "cuda":
            raise ValueError(f"the MC batch kernels run on the card, got "
                             f"{u.device}")
        if u.dtype != torch.uint8 or u.dim() != 2 or u.shape[1] != self.k:
            raise ValueError(f"u must be (batch, {self.k}) uint8, got "
                             f"{tuple(u.shape)} {u.dtype}")
        return u.contiguous()

    def encode_llr(self, u: torch.Tensor, noise: torch.Tensor,
                   ebn0_db: float, rate: float) -> torch.Tensor:
        """(batch, n) float32 LLRs of u's codewords through noise: the
        channel's of ``channel/awgn.py`` (and ``adapt.py`` with masks)
        bit for bit."""
        from tpu_ldpc_torch._build import check

        u = self._check_u(u)
        batch = u.shape[0]
        if (noise.dtype != torch.float32 or noise.device != u.device
                or tuple(noise.shape) != (batch, self.n)):
            raise ValueError(f"noise must be ({batch}, {self.n}) float32 on "
                             f"{u.device}, got {tuple(noise.shape)} "
                             f"{noise.dtype} on {noise.device}")
        noise = noise.contiguous()
        llr = torch.empty((batch, self.n), dtype=torch.float32,
                          device=u.device)
        if batch == 0:
            return llr
        sigma, scale = llr_constants(ebn0_db, rate)
        lib = self._lib()
        with torch.cuda.device(u.device):
            err = lib.ldpc_mc_encode_llr(
                u.data_ptr(), noise.data_ptr(), llr.data_ptr(),
                self.table.data_ptr(), _ptr(self.pos), _ptr(self.active_u),
                _ptr(self.tx_mask), _ptr(self.known_llr), batch, self.k,
                self.n, sigma, scale, torch.cuda.current_stream().cuda_stream)
        check(lib, err, "mc_encode_llr launch")
        LAUNCHES["mc_encode_llr"] += 1
        return llr

    def count(self, bits: torch.Tensor, u: torch.Tensor,
              passed: torch.Tensor, iters_used: torch.Tensor,
              out: torch.Tensor) -> torch.Tensor:
        """Adds the six counters (``sim/mc.py::COUNTER_FIELDS``) of a
        decoded batch into `out`, int64 (6,) on u's device; returns it."""
        from tpu_ldpc_torch._build import check

        u = self._check_u(u)
        batch = u.shape[0]
        for name, t, dtype, shape in (
                ("bits", bits, torch.uint8, (batch, self.n)),
                ("passed", passed, torch.bool, (batch,)),
                ("iters_used", iters_used, torch.int32, (batch,)),
                ("out", out, torch.int64, (6,))):
            if (t.dtype != dtype or t.device != u.device
                    or tuple(t.shape) != shape):
                raise ValueError(f"{name} must be {shape} {dtype} on "
                                 f"{u.device}, got {tuple(t.shape)} "
                                 f"{t.dtype} on {t.device}")
        if not out.is_contiguous():
            raise ValueError("out must be contiguous")
        if batch == 0:
            return out
        bits, passed = bits.contiguous(), passed.contiguous()
        iters_used = iters_used.contiguous()
        lib = self._lib()
        with torch.cuda.device(u.device):
            err = lib.ldpc_mc_count(
                bits.data_ptr(), u.data_ptr(), passed.data_ptr(),
                iters_used.data_ptr(), _ptr(self.info_cols),
                _ptr(self.active_u), batch, self.n, self.k, self.kp,
                out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        check(lib, err, "mc_count launch")
        LAUNCHES["mc_count"] += 1
        return out
