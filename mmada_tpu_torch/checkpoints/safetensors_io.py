"""The safetensors format, read and written without the `safetensors` package.

Counterpart of `iter_safetensors` (`mmada_tpu/checkpoints/hf_import.py`) and
of the file `export_safetensors` writes (`mmada_tpu/checkpoints/manager.py`).
A file is an 8-byte little-endian header length, a JSON header mapping each
key to `{"dtype", "shape", "data_offsets": [begin, end]}` (offsets into the
data that follows the header; an optional `"__metadata__"` entry holds
strings), then the tensors' raw little-endian bytes.

* `iter_safetensors(path)` yields `(key, tensor)` from one file, or from a
  checkpoint directory: its shards in `model.safetensors.index.json`'s file
  order (sorted names, as JAX's), else every `*.safetensors` file, sorted.
  Each tensor is read on its own, by offset, into a fresh host buffer: the
  host holds one tensor at a time, whatever the shard's size, and a tensor
  whose offset is not a multiple of its element size is read like any other.
* `save_file(tensors, path)` and `save_sharded(tensors, model_dir)` write
  tensors that may live on the card: each is made contiguous where it lies
  (a transposed view would otherwise be written as its storage, the fault
  `export_safetensors` guards against) and taken to the host alone.
  Headers are padded with spaces to a multiple of 8 bytes.

The machines this runs on are little-endian; a big-endian host raises.
"""

from __future__ import annotations

import json
import math
import os
import struct
import sys
from typing import Iterable, Iterator, Mapping, Optional, Union

import torch

INDEX_NAME = "model.safetensors.index.json"

DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32, "I64": torch.int64,
    "BOOL": torch.bool,
}
_NAMES = {dtype: name for name, dtype in DTYPES.items()}

Tensors = Union[Mapping[str, torch.Tensor], Iterable[tuple[str, torch.Tensor]]]


def _check_byteorder() -> None:
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors holds little-endian bytes; this host is big-endian")


def read_header(path: str) -> tuple[dict, int]:
    """(the header without `__metadata__`, the byte where the data starts)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def checkpoint_files(path: str) -> list[str]:
    """The safetensors files of a checkpoint: `path` itself if it is a file,
    else the shards its index names, else its `*.safetensors` files."""
    if os.path.isfile(path):
        return [path]
    index = os.path.join(path, INDEX_NAME)
    if os.path.exists(index):
        with open(index) as f:
            names = sorted(set(json.load(f)["weight_map"].values()))
    else:
        names = sorted(n for n in os.listdir(path) if n.endswith(".safetensors"))
    return [os.path.join(path, n) for n in names]


def iter_file(path: str) -> Iterator[tuple[str, torch.Tensor]]:
    """Each tensor of one file, in the order of its bytes, as a CPU tensor
    of the stored dtype."""
    _check_byteorder()
    header, start = read_header(path)
    entries = sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0])
    with open(path, "rb") as f:
        for key, info in entries:
            if info["dtype"] not in DTYPES:
                raise ValueError(f"{path}: {key} has dtype {info['dtype']}, "
                                 f"not one of {sorted(DTYPES)}")
            dtype, shape = DTYPES[info["dtype"]], info["shape"]
            begin, end = info["data_offsets"]
            nbytes = end - begin
            if nbytes != math.prod(shape) * dtype.itemsize:
                raise ValueError(f"{path}: {key} spans {nbytes} bytes, its shape {shape} "
                                 f"of {info['dtype']} needs {math.prod(shape) * dtype.itemsize}")
            buf = torch.empty(nbytes, dtype=torch.uint8)
            f.seek(start + begin)
            if nbytes and f.readinto(memoryview(buf.numpy())) != nbytes:
                raise ValueError(f"{path}: the file ends inside {key}")
            yield key, buf.view(dtype).reshape(shape)


def iter_safetensors(path: str) -> Iterator[tuple[str, torch.Tensor]]:
    """Every tensor of a file or of a checkpoint directory (`checkpoint_files`)."""
    for name in checkpoint_files(path):
        yield from iter_file(name)


def _items(tensors: Tensors) -> list[tuple[str, torch.Tensor]]:
    items = list(tensors.items() if isinstance(tensors, Mapping) else tensors)
    for key, t in items:
        if t.dtype not in _NAMES:
            raise ValueError(f"{key}: dtype {t.dtype} has no safetensors name")
    return items


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def save_file(tensors: Tensors, path: str, metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write `tensors` (a mapping or (key, tensor) pairs, on any device) to
    one file, in their order; returns the bytes written."""
    _check_byteorder()
    items = _items(tensors)
    header: dict = {}
    offset = 0
    for key, t in items:
        header[key] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + _nbytes(t)]}
        offset += _nbytes(t)
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in items:
            host = t.detach().contiguous().cpu()
            f.write(host.reshape(-1).view(torch.uint8).numpy().data)
    return 8 + len(raw) + offset


def save_sharded(tensors: Tensors, model_dir: str, max_shard_bytes: int = 5 * 10**9,
                 metadata: Optional[Mapping[str, str]] = None) -> list[str]:
    """Write `tensors` in order into shards of at most `max_shard_bytes` (a
    larger tensor takes a shard of its own), `model-00001-of-0000N.safetensors`,
    and `model.safetensors.index.json` (`total_size` and the key -> shard
    `weight_map`, the Hugging Face layout). Returns the shards' paths."""
    items = _items(tensors)
    shards: list[list[tuple[str, torch.Tensor]]] = [[]]
    size = 0
    for key, t in items:
        if shards[-1] and size + _nbytes(t) > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append((key, t))
        size += _nbytes(t)
    os.makedirs(model_dir, exist_ok=True)
    paths, weight_map = [], {}
    for i, shard in enumerate(shards, 1):
        name = f"model-{i:05d}-of-{len(shards):05d}.safetensors"
        paths.append(os.path.join(model_dir, name))
        save_file(shard, paths[-1], metadata)
        weight_map.update((key, name) for key, _ in shard)
    index = {"metadata": {"total_size": sum(_nbytes(t) for _, t in items)},
             "weight_map": weight_map}
    with open(os.path.join(model_dir, INDEX_NAME), "w") as f:
        json.dump(index, f, indent=2)
    return paths
