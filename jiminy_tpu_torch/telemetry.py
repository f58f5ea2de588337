"""Telemetry: constants and per-step columns, binary and HDF5 logs.

Counterpart of ``jiminy_tpu/telemetry.py``. A :class:`TelemetryLog` holds
string constants (the robot's JSON among them) and named float32 columns
(``time``, ``q.0`` …). The binary format is the reference's, byte for
byte:

    b"JTPU" | uint32 version 1 | uint64 header length | JSON header
    {"constants", "variables", "rows", "cols"} | float32 rows × cols

written by the reference's Python encoder (its C++ codec writes the same
bytes; :func:`append_rows` is the codec's append), so a log written by
either package reads in the other. HDF5
(``h5py``) and the pandas view (``pandas``) are imported only when used.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

MAGIC = b"JTPU"
VERSION = 1


@dataclass
class TelemetryLog:
    """Columnar telemetry: constants + named float32 time series."""

    constants: dict = field(default_factory=dict)
    columns: dict = field(default_factory=dict)  # name → (T,) float arrays

    @property
    def time(self) -> np.ndarray:
        return self.columns.get("time")

    def __len__(self) -> int:
        for v in self.columns.values():
            return len(v)
        return 0

    def as_matrix(self) -> tuple[list, np.ndarray]:
        """(column names, (T, n) float32 C-contiguous data)."""
        names = list(self.columns)
        data = np.stack([np.asarray(self.columns[n], np.float32) for n in names], axis=1)
        return names, np.ascontiguousarray(data, np.float32)

    def write_binary(self, path: str | Path) -> None:
        names, data = self.as_matrix()
        header = json.dumps({
            "constants": {k: str(v) for k, v in self.constants.items()},
            "variables": names,
            "rows": int(data.shape[0]),
            "cols": int(data.shape[1]),
        }).encode()
        with open(path, "wb") as f:
            f.write(MAGIC)
            f.write(np.uint32(VERSION).tobytes())
            f.write(np.uint64(len(header)).tobytes())
            f.write(header)
            f.write(data.tobytes())

    @staticmethod
    def read_binary(path: str | Path) -> "TelemetryLog":
        raw = Path(path).read_bytes()
        if raw[:4] != MAGIC:
            raise ValueError("not a jiminy_tpu log")
        hlen = int(np.frombuffer(raw[8:16], np.uint64)[0])
        header = json.loads(raw[16:16 + hlen].decode())
        data = np.frombuffer(raw[16 + hlen:], np.float32)
        cols = header["cols"]
        rows = data.size // cols  # the data block decides (appends allowed)
        data = data[: rows * cols].reshape(rows, cols)
        return TelemetryLog(
            constants=header["constants"],
            columns={n: data[:, i].copy() for i, n in enumerate(header["variables"])},
        )

    def write_hdf5(self, path: str | Path) -> None:
        import h5py

        with h5py.File(path, "w") as f:
            g = f.create_group("constants")
            for k, v in self.constants.items():
                g.attrs[k] = str(v)
            d = f.create_group("variables")
            for name, col in self.columns.items():
                d.create_dataset(name, data=np.asarray(col, np.float32))

    @staticmethod
    def read_hdf5(path: str | Path) -> "TelemetryLog":
        import h5py

        with h5py.File(path, "r") as f:
            constants = dict(f["constants"].attrs)
            columns = {k: np.asarray(v) for k, v in f["variables"].items()}
        return TelemetryLog(constants=constants, columns=columns)

    def to_dataframe(self):
        """The columns as a pandas DataFrame."""
        import pandas as pd

        return pd.DataFrame(self.columns)


def append_rows(path: str | Path, data) -> None:
    """Append (rows, cols) float32 rows to the binary log at ``path`` (the
    reference codec's ``jtpu_append_rows``): the header stays as it was
    written, and the reader takes the row count from the data block."""
    data = np.ascontiguousarray(data, np.float32)
    with open(path, "ab") as f:
        f.write(data.tobytes())


def read_log(path: str | Path) -> TelemetryLog:
    """A binary or HDF5 log, told apart by its first bytes."""
    path = Path(path)
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == MAGIC:
        return TelemetryLog.read_binary(path)
    if magic[:2] == b"\x89H":
        return TelemetryLog.read_hdf5(path)
    raise ValueError(f"unrecognized log format: {path}")


def stack_log(times, named_arrays: dict, constants: dict | None = None) -> TelemetryLog:
    """A log from stacked rollout outputs: each named array is (T,) or
    (T, d…); a vector channel becomes the columns ``name.0`` …
    ``name.{d-1}``, the reference's per-element naming."""
    cols: dict[str, np.ndarray] = {"time": np.asarray(times, np.float32)}
    for name, arr in named_arrays.items():
        arr = np.asarray(arr, np.float32)
        if arr.ndim == 1:
            cols[name] = arr
        else:
            arr = arr.reshape(arr.shape[0], -1)
            for i in range(arr.shape[1]):
                cols[f"{name}.{i}"] = arr[:, i]
    return TelemetryLog(constants=constants or {}, columns=cols)
