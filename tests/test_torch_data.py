"""The port's data pipeline (`mmada_tpu_torch/data/`, `train_torch.build_dataloader`)
against the JAX package's on shards the tests write: RefinedWeb parquet,
webdataset tars, an ImageNet folder, VQA / r2i folders. For the same seed
the readers give the same samples in the same order: text, captions, keys
and pixels equal (the port's readers take PIL's opener and transform from
`train_torch`; JAX's call PIL themselves). Also `CombinedLoader` in both
modes, `MixedStream`, the structured synthetic flows and gate helpers, the
native tar streamer (built with g++ where there is one), and
`train_torch.build_dataloader` against `train.build_dataloader` on the same
configs: noise flows, structured flows, ImageNet + tars + parquet (stage 1),
and the stage-4 mixtures. The readers that stream tars are compared with
one shard each where JAX's reader may take its native streamer, whose
threads interleave several shards in no fixed order.
"""

import io
import json
import os
import shutil
import tarfile

import numpy as np
import pytest
from PIL import Image

import train as jax_train
import train_torch
from mmada_tpu.core.config import load_config as jax_load_config
from mmada_tpu.data import captions as jax_captions
from mmada_tpu.data import combined as jax_combined
from mmada_tpu.data import imagenet as jax_imagenet
from mmada_tpu.data import synthetic as jax_synthetic
from mmada_tpu.data import text as jax_text
from mmada_tpu.data import transforms as jax_transforms
from mmada_tpu.data import vqa as jax_vqa
from mmada_tpu.data import webdataset as jax_wds
from mmada_tpu.prompting.universal import ByteTokenizer as JaxByteTokenizer
from mmada_tpu_torch.core.config import load_config
from mmada_tpu_torch.data import captions, combined, imagenet, native, synthetic, text, vqa
from mmada_tpu_torch.data import webdataset as wds
from mmada_tpu_torch.prompting.universal import ByteTokenizer

RES = 16


def _png(seed: int, size: int = 24) -> bytes:
    arr = (np.random.default_rng(seed).random((size, size + 8, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _add(tar, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def _write_tars(root, n_shards: int, per_shard: int, prefix: str = "shard") -> str:
    """Shards `{prefix}-{000..N-1}.tar` of png + txt (+ json) samples, one
    sample without an image and one whose image is corrupt."""
    os.makedirs(root, exist_ok=True)
    for s in range(n_shards):
        with tarfile.open(os.path.join(root, f"{prefix}-{s:03d}.tar"), "w") as tar:
            for i in range(per_shard):
                key = f"d{s}/sample{s}_{i:04d}"
                if i == 2:
                    _add(tar, f"{key}.png", b"not a png")
                elif i != 3:
                    _add(tar, f"{key}.png", _png(100 * s + i))
                _add(tar, f"{key}.caption.txt", f"caption {s}-{i} " .encode() + b"x" * i)
                if i % 2:
                    _add(tar, f"{key}.json", json.dumps({"i": i}).encode())
    return os.path.join(root, f"{prefix}-{{000..{n_shards - 1:03d}}}.tar")


def _write_parquet(root, n_files: int = 2, rows: int = 9, column: str = "content") -> str:
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    for f in range(n_files):
        texts = [" ".join(f"w{f}_{r}_{k}" for k in range(int(rng.integers(1, 40))))
                 for r in range(rows)]
        texts[1] = ""   # empty rows are skipped
        pq.write_table(pa.table({column: texts}), os.path.join(root, f"part-{f}.parquet"))
    return os.path.join(root, "*.parquet")


def _write_imagenet(root, classes=("n01", "n02_x"), per_class: int = 3) -> str:
    for c, cls in enumerate(classes):
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for i in range(per_class):
            with open(os.path.join(root, cls, f"img{i}.png"), "wb") as f:
                f.write(b"corrupt" if (c, i) == (0, 1) else _png(10 * c + i, 20 + 4 * i))
    return root


def _same(got, want) -> None:
    """Two samples (or batches) equal: strings and arrays exactly."""
    assert type(got) is type(want) or isinstance(got, type(want)) or isinstance(want, dict)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (sorted(got), sorted(want))
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want, (got, want)


def _take(it, n):
    it = iter(it)
    return [next(it) for _ in range(n)]


def _jax_transform(img):
    return jax_transforms.image_transform(img, RES)


def _port_transform(img):
    return train_torch.image_transform(img, RES)


# ------------------------------------------------------------------ text

@pytest.mark.parametrize("shuffle_buffer,max_length,repeat", [(1, 8000, False), (4, 30, True)])
def test_refinedweb_matches_jax(tmp_path, shuffle_buffer, max_length, repeat):
    path = _write_parquet(str(tmp_path))
    kw = dict(shuffle_buffer=shuffle_buffer, max_length=max_length, repeat=repeat, seed=3)
    want = jax_text.RefinedWebDataset(path, **kw)
    got = text.RefinedWebDataset(path, **kw)
    assert got.files == want.files
    n = 16 if not repeat else 40   # two epochs and more
    _same(list(got)[:n] if not repeat else _take(got, n),
          list(want)[:n] if not repeat else _take(want, n))
    _same(list(text.batched(_take(got, 7), 3)), list(jax_text.batched(_take(want, 7), 3)))


def test_chat_dataset_matches_jax(tmp_path):
    path = _write_parquet(str(tmp_path), column="text")
    want = jax_text.ChatDataset(path, tokenizer=JaxByteTokenizer(), max_token_length=60,
                                shuffle_buffer=3)
    got = text.ChatDataset(path, tokenizer=ByteTokenizer(), max_token_length=60,
                           shuffle_buffer=3)
    _same(_take(got, 12), _take(want, 12))


def test_expand_files_and_bad_parquet(tmp_path):
    path = _write_parquet(str(tmp_path), n_files=1)
    with open(tmp_path / "part-9.parquet", "wb") as f:
        f.write(b"not parquet")
    kw = dict(shuffle_buffer=1, repeat=False)
    _same(list(text.RefinedWebDataset(path, **kw)), list(jax_text.RefinedWebDataset(path, **kw)))
    assert text.expand_files([path, "missing"]) == jax_text.expand_files([path, "missing"])


# ----------------------------------------------------------- webdataset

def test_brace_expand_and_wds_names():
    for pattern in ("s-{0..3}.tar", "a{00..02}/b{1..2}.tar", "plain.tar"):
        assert wds.brace_expand(pattern) == jax_wds.brace_expand(pattern)
    for name in ("dir/000123.caption.txt", "x.y/z.JPG", "noext", "a/b.c.d"):
        assert wds.split_wds_name(name) == jax_wds.split_wds_name(name)


@pytest.mark.parametrize("resample,shuffle_buffer", [(False, 1), (False, 5), (True, 3)])
def test_webdataset_reader_matches_jax(tmp_path, resample, shuffle_buffer):
    shards = _write_tars(str(tmp_path), 3, 6)
    kw = dict(shuffle_buffer=shuffle_buffer, resample=resample, seed=7, use_native=False)
    want = jax_wds.WebDatasetReader(shards, transform=_jax_transform, **kw)
    got = wds.WebDatasetReader(shards, train_torch.open_image, transform=_port_transform, **kw)
    assert got.native is False
    n = 12 if not resample else 30
    a, b = _take(got, n), _take(want, n)
    _same(a, b)
    assert all(s["pixels"].shape == (RES, RES, 3) for s in a)
    _same(wds.collate_image_text(a[:4]), jax_wds.collate_image_text(b[:4]))


def test_webdataset_caption_joins_match_jax(tmp_path):
    shards = _write_tars(str(tmp_path / "tars"), 2, 6)
    capdir = tmp_path / "caps"
    capdir.mkdir()
    for s in range(2):
        for i in range(0, 6, 2):
            (capdir / f"sample{s}_{i:04d}.txt").write_text(f"joined {s} {i}\n")
    csv_path = tmp_path / "qa.csv"
    rows = ["image,question,answer,reasoning"] + [
        f"sample{s}_{i:04d}.png,q{s}{i},a{s}{i},r{s}{i}" for s in range(2) for i in range(6)
        for _ in range(2)]
    csv_path.write_text("\n".join(rows) + "\n")
    jdb = tmp_path / "jdb.json"
    jdb.write_text(json.dumps([{"img_path": f"x/sample0_{i:04d}.jpg", "prompt": f"p{i}"}
                               for i in range(6)]))

    def pair(make):
        return make(captions), make(jax_captions)

    cases = [
        pair(lambda m: m.caption_dir_join(str(capdir))),
        pair(lambda m: m.qa_csv_join(str(csv_path), reasoning_column="reasoning", use_cot=True,
                                     seed=2)),
        pair(lambda m: m.qa_csv_join(str(csv_path), seed=5)),
        pair(lambda m: m.journeydb_join(str(jdb))),
        pair(lambda m: m.add_caption_prompt(seed=1)),
        pair(lambda m: m.first_of(m.caption_dir_join(str(capdir)),
                                  m.add_caption_prompt(m.journeydb_join(str(jdb)), seed=4))),
    ]
    for port_fn, jax_fn in cases:
        kw = dict(shuffle_buffer=2, resample=False, use_native=False, max_caption_len=160)
        got = list(wds.WebDatasetReader(shards, train_torch.open_image, caption_fn=port_fn,
                                        transform=_port_transform, **kw))
        want = list(jax_wds.WebDatasetReader(shards, caption_fn=jax_fn,
                                             transform=_jax_transform, **kw))
        assert got
        _same(got, want)


def test_decode_sample_takes_the_opener():
    raw = {"__key__": "k", "png": _png(1), "txt": b" hi ", "json": b'{"a": 1}'}
    out = wds.decode_sample(raw, train_torch.open_image)
    want = jax_wds.decode_sample(raw)
    assert out["caption"] == want["caption"] == "hi" and out["json"] == want["json"]
    np.testing.assert_array_equal(np.asarray(out["image"]), np.asarray(want["image"]))
    assert wds.decode_sample(dict(raw, png=b"bad"), train_torch.open_image) is None


def test_native_tar_reader_matches_tarfile(tmp_path):
    """The C++ streamer, built with g++ into the port's build directory: the
    same raw samples as Python's tarfile, in shard order with one thread,
    and the same set through the reader with four."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler on PATH: the native tar streamer cannot be built here")
    assert native.available(), "g++ is present but libtario did not build"
    assert os.path.dirname(native.library_path()).endswith("_kernels_build")
    pattern = _write_tars(str(tmp_path), 3, 5)
    shards = wds.expand_shards(pattern)
    want = []
    for shard in shards:
        with tarfile.open(shard, mode="r|*") as tar:
            want += list(wds._group_tar_samples(tar))
    reader = native.NativeTarReader(shards, threads=1)
    try:
        got = list(reader)
        stats = reader.stats()
    finally:
        reader.close()
    _same(got, want)
    assert stats["samples"] == len(want)
    kw = dict(shuffle_buffer=1, resample=False)
    fast = wds.WebDatasetReader(pattern, train_torch.open_image, transform=_port_transform, **kw)
    slow = jax_wds.WebDatasetReader(pattern, transform=_jax_transform, use_native=False, **kw)
    assert fast.native is True
    a = sorted(fast, key=lambda s: s["__key__"])
    b = sorted(slow, key=lambda s: s["__key__"])
    _same(a, b)


# -------------------------------------------------------------- imagenet

def test_imagenet_matches_jax(tmp_path):
    root = _write_imagenet(str(tmp_path / "in"))
    mapping = tmp_path / "map.txt"
    mapping.write_text("n01 tench, Tinca tinca\nbad-line\n")
    want = jax_imagenet.ImageNetDataset(root, str(mapping), resolution=RES, seed=5)
    got = imagenet.ImageNetDataset(root, str(mapping), resolution=RES, seed=5,
                                   open_image=train_torch.open_image,
                                   transform=train_torch.image_transform)
    assert len(got) == len(want) == 6
    a, b = _take(got, 14), _take(want, 14)   # past two epochs, the bad file retried
    _same(a, b)
    assert {s["caption"] for s in a} == {"tench, Tinca tinca", "n02 x"}
    _same(imagenet.collate_imagenet(a[:3]), jax_imagenet.collate_imagenet(b[:3]))
    assert imagenet.load_label_mapping(str(mapping)) == jax_imagenet.load_label_mapping(
        str(mapping))


# ------------------------------------------------------------------- vqa

def _squash(img, res):
    return jax_transforms.image_transform_squash(img, res)


def test_vqa_and_r2i_match_jax(tmp_path):
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    records = []
    for i in range(4):
        (imgs / f"im{i}.png").write_bytes(_png(i))
        turns = [{"from": "human" if t % 2 == 0 else "gpt", "value": f"<image>t{i}{t}"}
                 for t in range(2 + 2 * i)]
        records.append({"image": f"im{i}.png", "conversations": turns})
    records.append({"image": "missing.png", "conversations": records[0]["conversations"]})
    js = tmp_path / "vqa.json"
    js.write_text(json.dumps(records))
    want = jax_vqa.VQADataset(str(js), str(imgs), resolution=RES, seed=3)
    got = vqa.VQADataset(str(js), str(imgs), resolution=RES, seed=3,
                         open_image=train_torch.open_image, transform=_squash)
    _same(_take(got, 10), _take(want, 10))

    caps, short = tmp_path / "caps", tmp_path / "short"
    caps.mkdir(), short.mkdir()
    for i in range(3):
        (caps / f"im{i}.txt").write_text(f"long caption {i}")
        (short / f"im{i}.txt").write_text(f"short {i}")
    want = jax_vqa.R2iDataset(str(imgs), str(caps), str(short), resolution=RES, seed=2)
    got = vqa.R2iDataset(str(imgs), str(caps), str(short), resolution=RES, seed=2,
                         open_image=train_torch.open_image, transform=_squash)
    _same(_take(got, 8), _take(want, 8))   # im3 has no captions: dropped alike
    assert vqa.render_chat(records[1]["conversations"]) == jax_vqa.render_chat(
        records[1]["conversations"])


def test_mixed_stream_matches_jax():
    def streams():
        return {"a": iter(range(0, 10**6)), "b": iter(range(10**6, 2 * 10**6)),
                "c": iter(range(2 * 10**6, 3 * 10**6))}

    weights = {"a": 0.5, "b": 0.3, "c": 0.2}
    _same(_take(vqa.MixedStream(streams(), weights, seed=9), 200),
          _take(jax_vqa.MixedStream(streams(), weights, seed=9), 200))
    with pytest.raises(ValueError):
        vqa.MixedStream(streams(), {"a": 1.0})


# -------------------------------------------------------------- combined

@pytest.mark.parametrize("mode", ["max_size_cycle", "min_size"])
def test_combined_loader_matches_jax(mode):
    flows = {"a": [1, 2, 3, 4, 5], "b": ["x", "y"], "c": (9.0, 8.0, 7.0)}
    _same(list(combined.CombinedLoader(flows, mode)), list(jax_combined.CombinedLoader(flows, mode)))
    with pytest.raises(ValueError):
        combined.CombinedLoader(flows, "zip")


# ------------------------------------------------------------- synthetic

def test_structured_flows_and_gate_helpers_match_jax():
    overrides = ["dataset.synthetic_structured=true", "dataset.lm_pack_chars=200",
                 "dataset.preprocessing.resolution=16", "dataset.n_patterns=7",
                 "training.batch_size_t2i=2", "training.batch_size_lm=3",
                 "training.batch_size_mmu=2"]
    got = synthetic.build_structured_flows(load_config(overrides=overrides))
    want = jax_synthetic.build_structured_flows(jax_load_config(overrides=overrides))
    assert sorted(got) == sorted(want)
    for k in want:
        _same(_take(got[k], 3), _take(want[k], 3))
    _same(_take(synthetic.text_batches(2, pack_chars=0), 2),
          _take(jax_synthetic.text_batches(2, pack_chars=0), 2))
    tok, jtok = ByteTokenizer(), JaxByteTokenizer()
    np.testing.assert_array_equal(synthetic.gate_forward_ids(tok, n=3, seq_len=20),
                                  jax_synthetic.gate_forward_ids(jtok, n=3, seq_len=20))
    rows = synthetic.gate_decode_prompt_rows(tok, 1, n=3, prompt_len=12)
    np.testing.assert_array_equal(rows, jax_synthetic.gate_decode_prompt_rows(
        jtok, 1, n=3, prompt_len=12))
    truths = synthetic.gate_text_truth(tok, 1, n=3, prompt_len=12)
    _same(truths, jax_synthetic.gate_text_truth(jtok, 1, n=3, prompt_len=12))
    gen = np.stack([t[:4] for t in truths])
    assert synthetic.truth_accuracy(gen, truths) == jax_synthetic.truth_accuracy(gen, truths)
    assert synthetic.require_truth(truths) is truths
    with pytest.raises(ValueError):
        synthetic.require_truth([None])


# ---------------------------------------------------- build_dataloader

def _loader_pair(overrides, base="configs/tiny_test.yaml"):
    got = train_torch.build_dataloader(load_config(base, reader=train_torch._yaml,
                                                   overrides=overrides))
    want = jax_train.build_dataloader(jax_load_config(base, overrides=overrides))
    return got, want


def _stage_data(tmp_path):
    """One parquet file, an ImageNet folder and one mmu tar shard."""
    return (_write_parquet(str(tmp_path / "lm"), n_files=1),
            _write_imagenet(str(tmp_path / "imagenet")),
            _write_tars(str(tmp_path / "mmu"), 1, 6))


@pytest.mark.parametrize("case", ["synthetic", "synthetic_structured", "stage1", "stage4"])
def test_build_dataloader_matches_train_py(tmp_path, case):
    res = [f"dataset.preprocessing.resolution={RES}"]
    if case == "synthetic":
        overrides = res + ["dataset.synthetic=true"]
    elif case == "synthetic_structured":
        overrides = res + ["dataset.synthetic_structured=true", "dataset.lm_pack_chars=100"]
    else:
        lm, root, mmu = _stage_data(tmp_path)
        overrides = res + [
            "dataset.gen_type=imagenet1k", "dataset.params.shuffle_buffer_size=3",
            f"dataset.params.train_t2i_shards_path_or_url={root}",
            f"dataset.params.train_lm_shards_path_or_url={lm}",
            f"dataset.params.train_mmu_shards_path_or_url={mmu}",
        ]
        if case == "stage4":
            lm2 = _write_parquet(str(tmp_path / "instruct"), n_files=1, rows=5)
            mmu2 = _write_tars(str(tmp_path / "vqa"), 1, 5, prefix="vqa")
            overrides += [
                "dataset.params.base_in_lm_coeff=0.6",
                f"dataset.params.train_instruct_lm_shards_path_or_url={lm2}",
                f"dataset.params.train_cot_mmu_shards_path_or_url={mmu}",
                f"dataset.params.train_vqa_mmu_shards_path_or_url={mmu2}",
                "dataset.params.cot_in_mmu_coeff=0.3", "dataset.params.vqa_in_mmu_coeff=0.7",
            ]
    got, want = _loader_pair(overrides)
    a, b = _take(got, 3), _take(want, 3)
    _same(a, b)
    assert sorted(a[0]) == ["lm_flow", "mmu_flow", "t2i_flow"]
