"""Memory-mapped indexed dataset (a ``.bin``/``.idx`` pair).

Counterpart of ``deepspeed_tpu/runtime/indexed_dataset.py`` (host code,
copied): token corpora as two flat files, ``.bin`` holding the raw sample
arrays back to back and ``.idx`` holding the dtype, per-sample lengths
and byte offsets, read through ``np.memmap`` so a corpus of hundreds of
GB costs no resident memory.  The files are byte for byte those of the
JAX package: either package reads what the other wrote.
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

_MAGIC = b"DSTPUIDX\x01"

_DTYPES = {
    1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32, 5: np.int64,
    6: np.float32, 7: np.float64, 8: np.uint16, 9: np.uint32,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def data_file_path(prefix: str) -> str:
    return prefix + ".bin"


def index_file_path(prefix: str) -> str:
    return prefix + ".idx"


class MMapIndexedDatasetBuilder:
    """Append samples, then ``finalize()`` writes the index."""

    def __init__(self, prefix: str, dtype=np.int32):
        self.prefix = prefix
        self.dtype = np.dtype(dtype)
        if self.dtype not in _DTYPE_CODES:
            raise ValueError(f"unsupported dtype {dtype}")
        self._bin = open(data_file_path(prefix), "wb")
        self._sizes: list = []

    def add_item(self, arr) -> None:
        a = np.asarray(arr, dtype=self.dtype)
        if a.ndim != 1:
            raise ValueError(f"samples must be 1-D, got shape {a.shape}")
        self._bin.write(a.tobytes(order="C"))
        self._sizes.append(len(a))

    def merge_file(self, other_prefix: str) -> None:
        """Append another shard's samples (the reduce step of parallel
        corpus building)."""
        other = MMapIndexedDataset(other_prefix)
        if other.dtype != self.dtype:
            raise ValueError("dtype mismatch in merge")
        with open(data_file_path(other_prefix), "rb") as f:
            while True:
                chunk = f.read(1 << 24)
                if not chunk:
                    break
                self._bin.write(chunk)
        self._sizes.extend(other.sizes.tolist())

    def finalize(self) -> None:
        self._bin.close()
        sizes = np.asarray(self._sizes, np.int64)
        offsets = np.zeros(len(sizes) + 1, np.int64)
        np.cumsum(sizes * self.dtype.itemsize, out=offsets[1:])
        with open(index_file_path(self.prefix), "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<BQ", _DTYPE_CODES[self.dtype],
                                len(sizes)))
            f.write(sizes.tobytes())
            f.write(offsets.tobytes())


class MMapIndexedDataset:
    """Zero-copy sample access over the ``.bin`` through np.memmap."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        with open(index_file_path(prefix), "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"bad index magic in {prefix}.idx")
            code, n = struct.unpack("<BQ", f.read(9))
            self.dtype = np.dtype(_DTYPES[code])
            self.sizes = np.frombuffer(f.read(8 * n), np.int64)
            self.offsets = np.frombuffer(f.read(8 * (n + 1)), np.int64)
        self._data = np.memmap(data_file_path(prefix), mode="r",
                               dtype=np.uint8)

    def __len__(self) -> int:
        return len(self.sizes)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        lo, hi = self.offsets[i], self.offsets[i + 1]
        return np.frombuffer(self._data[lo:hi], dtype=self.dtype)

    def batch(self, indices: Sequence[int], seq_len: int,
              pad_id: int = 0) -> np.ndarray:
        """Gather samples into a right-padded/truncated [B, seq_len]
        batch (host side; feeds ``shard_batch``)."""
        out = np.full((len(indices), seq_len), pad_id, self.dtype)
        for r, i in enumerate(indices):
            s = self[i][:seq_len]
            out[r, :len(s)] = s
        return out

    @property
    def total_tokens(self) -> int:
        return int(self.sizes.sum())
