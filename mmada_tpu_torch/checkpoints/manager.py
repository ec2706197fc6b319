"""Train-state checkpoints: save, rotate, resume the latest.

Counterpart of `mmada_tpu/checkpoints/manager.py:30-127` (the reference's
training/train_mmada.py:404-436, 935-973) on the port's own safetensors
writer and reader (`checkpoints/safetensors_io.py`, BF16 included) instead
of Orbax. `{output_dir}/checkpoint-{step}/` holds

  * `state/`: the flattened state as safetensors shards of at most 5 GB
    with `model.safetensors.index.json`; a tree of dicts and lists of
    tensors is flattened to keys joined by "/" (`train/params/layers/0/q_proj`,
    `train/opt_state/mu/wte`, `ema/shadow/wte`, ...);
  * `metadata.json`: `{"global_step": N, ...}`, written last, after the
    shards are on disk (fsync), so a directory without it (a save in flight,
    or torn by a crash) is invisible to `list_checkpoints`, `latest` and the
    rotation.

`checkpoints_total_limit` keeps the newest N complete checkpoints. `save(...,
wait=False)` copies every tensor to the host up front (the train step
updates its tensors in place, so a later copy would be a torn state), then
writes the shards from a thread while training goes on; the next `save` or
`finalize()` waits for it and then writes `metadata.json` and rotates, as
Orbax's async save does in JAX. `restore(template)` checks every key, shape
and dtype against the shards' headers before it reads a byte, then copies
each tensor into the template's tensor, on its device: any missing or extra
key or any shape or dtype mismatch raises, and nothing is half restored.

Exports of bare weights for serving are `hf_import.export_pretrained`;
`save_params_only` / `load_params_only` write and read any tree of tensors
(or a module's state dict, the motion VQ-VAE's) as safetensors shards.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
import time
from typing import Any, Optional

import torch

from mmada_tpu_torch.checkpoints import safetensors_io

logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"checkpoint-(\d+)$")
METADATA = "metadata.json"
STATE = "state"


def _item_path(output_dir: str, step: int) -> str:
    return os.path.join(output_dir, f"checkpoint-{step}")


def list_checkpoints(output_dir: str) -> list[tuple[int, str]]:
    """(step, path) of every complete checkpoint (one with `metadata.json`),
    oldest first."""
    if not os.path.isdir(output_dir):
        return []
    out = []
    for name in os.listdir(output_dir):
        m = _CKPT_RE.match(name)
        if not m:
            continue
        path = os.path.join(output_dir, name)
        if os.path.exists(os.path.join(path, METADATA)):
            out.append((int(m.group(1)), path))
    return sorted(out)


def latest_checkpoint(output_dir: str) -> Optional[str]:
    ckpts = list_checkpoints(output_dir)
    return ckpts[-1][1] if ckpts else None


def flatten(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """A tree of dicts and lists of tensors as {"a/b/0/c": tensor}."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(f"{prefix or 'the state'}: {type(tree).__name__} is not a tensor, "
                        "dict or list")
    out: dict[str, torch.Tensor] = {}
    for k, v in items:
        key = str(k)
        if "/" in key:
            raise ValueError(f"key {key!r} under {prefix!r} holds '/', the separator")
        out.update(flatten(v, f"{prefix}/{key}" if prefix else key))
    return out


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, output_dir: str, total_limit: Optional[int] = None):
        self.output_dir = os.path.abspath(output_dir)
        self.total_limit = total_limit
        os.makedirs(self.output_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._pending = None      # (path, metadata) of the save in flight
        self._error: Optional[BaseException] = None
        self.last_save: dict = {}  # timings of the last save (see `save`)

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Any, extra_metadata: Optional[dict] = None,
             wait: bool = True) -> str:
        """Write checkpoint-{step} (see the module docstring). With
        `wait=False` the host snapshot is taken here and the shards are
        written from a thread; `finalize()` lands them. `last_save` records
        `{"step", "bytes", "snapshot_s", "write_s" (None while in flight),
        "wait"}`."""
        self.finalize()  # at most one save in flight
        path = _item_path(self.output_dir, step)
        if os.path.exists(path):
            shutil.rmtree(path)
        flat = flatten(state)
        meta = {"global_step": int(step), **(extra_metadata or {})}
        t0 = time.perf_counter()
        if not wait:
            # the copy lands before the next step changes the tensors in place
            flat = {k: t.detach().to("cpu", copy=True) for k, t in flat.items()}
        snapshot_s = time.perf_counter() - t0
        nbytes = sum(t.numel() * t.element_size() for t in flat.values())
        self.last_save = {"step": int(step), "bytes": nbytes, "snapshot_s": snapshot_s,
                          "write_s": None, "wait": wait}
        self._pending = (path, meta)
        if wait:
            self._write(path, flat)
            self.finalize()
        else:
            self._thread = threading.Thread(target=self._write, args=(path, flat),
                                            name=f"checkpoint-{step}", daemon=True)
            self._thread.start()
        return path

    def _write(self, path: str, flat: dict) -> None:
        t0 = time.perf_counter()
        try:
            shards = safetensors_io.save_sharded(flat.items(), os.path.join(path, STATE))
            for shard in shards:
                _fsync(shard)
            _fsync(os.path.join(path, STATE, safetensors_io.INDEX_NAME))
        except BaseException as e:  # re-raised by finalize on the caller's thread
            self._error = e
        finally:
            flat.clear()  # the host snapshot goes as soon as it is written
        self.last_save["write_s"] = time.perf_counter() - t0

    def finalize(self) -> None:
        """Wait for the save in flight, then write its `metadata.json` and
        rotate. Raises what the writer raised (the checkpoint then stays
        incomplete, so invisible)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending is None:
            return
        path, meta = self._pending
        self._pending = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError(f"writing {path} failed") from error
        meta_path = os.path.join(path, METADATA)
        with open(meta_path, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        self._rotate()

    def _rotate(self) -> None:
        if self.total_limit is None:
            return
        ckpts = list_checkpoints(self.output_dir)
        while len(ckpts) > self.total_limit:
            _, path = ckpts.pop(0)
            shutil.rmtree(path, ignore_errors=True)

    # ---------------------------------------------------------- restore
    def restore(self, template: Any, step: Optional[int] = None):
        """Copy the latest checkpoint (or checkpoint-`step`) into the
        tensors of `template`, in place. Returns (template, global_step), or
        (None, 0) when there is no checkpoint."""
        self.finalize()
        if step is None:
            path = latest_checkpoint(self.output_dir)
            if path is None:
                return None, 0
        else:
            path = _item_path(self.output_dir, step)
        with open(os.path.join(path, METADATA)) as f:
            meta = json.load(f)
        _load_into(os.path.join(path, STATE), flatten(template), path)
        return template, int(meta["global_step"])


def _load_into(state_dir: str, flat: dict, what: str) -> None:
    """Copy the shards of `state_dir` into the tensors of `flat`, after every
    key, shape and dtype is checked against the shards' headers."""
    stored = {}
    for name in safetensors_io.checkpoint_files(state_dir):
        header, _ = safetensors_io.read_header(name)
        stored.update(header)
    missing, extra = sorted(set(flat) - set(stored)), sorted(set(stored) - set(flat))
    if missing or extra:
        raise ValueError(f"{what}: keys differ from the template: missing {missing[:8]} "
                         f"({len(missing)}), extra {extra[:8]} ({len(extra)})")
    for key, t in flat.items():
        info = stored[key]
        dtype = safetensors_io.DTYPES.get(info["dtype"])
        if tuple(info["shape"]) != tuple(t.shape) or dtype != t.dtype:
            raise ValueError(f"{what}: {key} is {info['dtype']} {info['shape']}, the "
                             f"template's {t.dtype} {list(t.shape)}")
    with torch.no_grad():
        for key, t in safetensors_io.iter_safetensors(state_dir):
            flat[key].copy_(t)


def _flat_params(params: Any) -> dict[str, torch.Tensor]:
    """A tree of tensors, or a module's state dict, flattened."""
    if isinstance(params, torch.nn.Module):
        return dict(params.state_dict())
    return flatten(params)


def save_params_only(path: str, params: Any) -> str:
    """Export bare params (a tree of tensors, or a module such as the motion
    VQ-VAE) as safetensors shards with an index under `path`, replacing what
    was there (`mmada_tpu/checkpoints/manager.py:128-136`; the reference's
    `unwrapped_model` safetensors)."""
    if os.path.exists(path):
        shutil.rmtree(path)
    flat = {k: t.detach() for k, t in _flat_params(params).items()}
    safetensors_io.save_sharded(flat.items(), path)
    return path


def load_params_only(path: str, template: Any) -> Any:
    """Copy the params saved under `path` into `template`'s tensors (a tree or
    a module), in place, each key, shape and dtype checked first; returns
    `template`."""
    _load_into(path, _flat_params(template), path)
    return template
