"""The port's training data layer against the JAX package's: TFRecords
written by one package and read by the other (native and pure-Python
framing, CRCs checked), the Example codec, fragments of a synthetic
structure, the fragment reader and splitter, FragmentLoader's batches and
order for a seed, and the msgpack writer behind save_model."""
import os
import struct
import sys

import numpy as np
import pytest

from nmrgnn_tpu import native as jnative
from nmrgnn_tpu.data import dataset as jds
from nmrgnn_tpu.data import fragment as jfrag
from nmrgnn_tpu.data import tfrecord as jtf
from nmrgnn_tpu.data.pdb import read_structure as jread_structure
from nmrgnn_tpu_torch import _msgpack, native
from nmrgnn_tpu_torch.data import dataset as ds
from nmrgnn_tpu_torch.data import fragment as frag
from nmrgnn_tpu_torch.data import tfrecord as tf
from nmrgnn_tpu_torch.data.pdb import read_structure

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import write_synthetic_pdb  # noqa: E402


@pytest.fixture(scope="module")
def pdb(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data") / "s.pdb")
    write_synthetic_pdb(path, n_atoms=300, seed=1, frames=2)
    return path


@pytest.fixture(params=["native", "python"])
def framing(request, monkeypatch):
    """Run a test with the native runtime, and with it absent (the port's
    pure-Python framing and CRC)."""
    if request.param == "python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    else:
        assert native.available()
    return request.param


def _examples(n=5, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append({
            "ints": rng.integers(-2 ** 40, 2 ** 40, size=7 + i).astype(np.int64),
            "floats": rng.normal(size=3 + 2 * i).astype(np.float32),
            "names": [b"x" * i, b"abc"],
            "empty": np.zeros(0, np.float32),
        })
    return out


def _same_example(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], list):
            assert a[k] == b[k]
        else:
            np.testing.assert_array_equal(a[k], b[k])


def test_crc32c_matches_jax():
    for data in (b"", b"a", b"123456789", bytes(range(256)) * 3):
        assert tf.crc32c(data) == jtf.crc32c(data)
        assert tf.masked_crc(data) == jtf.masked_crc(data)
    assert tf.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


def test_encode_example_matches_jax():
    for ex in _examples():
        assert tf.encode_example(ex) == jtf.encode_example(ex)
        _same_example(tf.decode_example(jtf.encode_example(ex)), jtf.decode_example(
            jtf.encode_example(ex)))


def test_port_writes_jax_reads(tmp_path, framing):
    path = str(tmp_path / "p.tfrecord")
    exs = _examples()
    with tf.TFRecordWriter(path, flush_every=2) as w:
        for ex in exs:
            w.write_example(ex)
    got = list(jtf.read_examples(path, check_crc=True))
    assert len(got) == len(exs)
    for a, b in zip(got, exs):
        _same_example(a, b)
    with pytest.raises(ValueError):
        w.write(b"late")


def test_jax_writes_port_reads(tmp_path, framing):
    path = str(tmp_path / "j.tfrecord")
    exs = _examples(seed=3)
    with jtf.TFRecordWriter(path) as w:
        for ex in exs:
            w.write_example(ex)
    got = list(tf.read_examples(path, check_crc=True))
    assert len(got) == len(exs)
    for a, b in zip(got, exs):
        _same_example(a, b)


def test_crc_mismatch_raises(tmp_path, framing):
    path = str(tmp_path / "bad.tfrecord")
    with tf.TFRecordWriter(path) as w:
        w.write(b"payload-bytes")
    raw = bytearray(open(path, "rb").read())
    raw[12] ^= 0xFF  # the first payload byte
    open(path, "wb").write(bytes(raw))
    assert list(tf.read_tfrecord(path)) == [bytes(raw[12:12 + 13])]
    with pytest.raises(IOError, match="CRC"):
        list(tf.read_tfrecord(path, check_crc=True))


def test_native_and_python_framing_write_the_same_bytes(tmp_path, monkeypatch):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    payloads = [b"", b"one", bytes(range(200))]
    with tf.TFRecordWriter(a) as w:
        for p in payloads:
            w.write(p)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with tf.TFRecordWriter(b) as w:
        for p in payloads:
            w.write(p)
    assert open(a, "rb").read() == open(b, "rb").read()
    header = struct.pack("<Q", 3)
    assert tf.masked_crc(header) == jtf.masked_crc(header)


def test_native_library_builds_into_build_dir():
    assert native.available() and jnative.available()
    assert native.library_path().startswith(native.BUILD_DIR)
    assert os.path.exists(native.library_path())


def test_fragments_match_jax(pdb, tmp_path):
    """The port's fragments of a structure equal the JAX package's, record
    for record and byte for byte in the file."""
    struct, jstruct = read_structure(pdb), jread_structure(pdb)
    got = list(frag.fragment_structure(struct, frame=1, fragment_size=64))
    want = list(jfrag.fragment_structure(jstruct, frame=1, fragment_size=64))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(frag.name_index_for(struct), jfrag.name_index_for(jstruct))
    np.testing.assert_array_equal(frag.synthetic_shift(got[0]["atom_idx"], got[0]["edges"]),
                                  jfrag.synthetic_shift(want[0]["atom_idx"], want[0]["edges"]))
    p, j = str(tmp_path / "p.tfrecord"), str(tmp_path / "j.tfrecord")
    assert frag.write_structure_fragments(p, struct, fragment_size=64) == \
        jfrag.write_structure_fragments(j, jstruct, fragment_size=64)
    assert open(p, "rb").read() == open(j, "rb").read()
    p, j = str(tmp_path / "pr.tfrecord"), str(tmp_path / "jr.tfrecord")
    shifts = np.full((2, struct.n_atoms), np.nan, np.float32)
    shifts[:, ::3] = 7.5
    assert frag.write_structure_records(p, struct, shifts=shifts) == \
        jfrag.write_structure_records(j, jstruct, shifts=shifts) == 2
    assert open(p, "rb").read() == open(j, "rb").read()


def _same_sample(a, b):
    for f in ("atoms", "nlist", "edges", "inv_degree"):
        np.testing.assert_array_equal(getattr(a.graph, f), getattr(b.graph, f), err_msg=f)
    np.testing.assert_array_equal(a.y, b.y)
    np.testing.assert_array_equal(a.w, b.w)


@pytest.fixture(scope="module")
def records(pdb, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("records") / "f.tfrecord")
    jfrag.write_structure_fragments(path, jread_structure(pdb), fragment_size=64)
    return path


def test_read_fragments_and_split_match_jax(records):
    got, want = list(ds.read_fragments(records)), list(jds.read_fragments(records))
    assert len(got) == len(want) > 8
    for a, b in zip(got, want):
        _same_sample(a, b)
    (tr, va), (jtr, jva) = ds.split_dataset([records], 0.25), jds.split_dataset([records], 0.25)
    assert (len(tr), len(va)) == (len(jtr), len(jva)) and len(va) > 0
    for a, b in zip(tr + va, jtr + jva):
        _same_sample(a, b)
    with pytest.raises(ValueError, match="missing fields"):
        ds.example_to_sample({"atoms": np.zeros(3, np.int64)}, 10)
    bad = tf.decode_example(next(tf.read_tfrecord(records)))
    bad["atoms"] = bad["atoms"] + 10
    with pytest.raises(ValueError, match="vocabulary"):
        ds.example_to_sample(bad, 10)


@pytest.mark.parametrize("shuffle,drop", [(True, False), (False, False), (True, True)])
def test_fragment_loader_matches_jax(records, shuffle, drop):
    """The same batches in the same order for a seed, over two epochs, the
    ragged last batch filled with zero-weight repeats of its last sample."""
    samples = list(ds.read_fragments(records))[:11]
    jsamples = list(jds.read_fragments(records))[:11]
    kw = dict(pad_to=64, batch_size=4, shuffle=shuffle, seed=5, drop_remainder=drop)
    loader, jloader = ds.FragmentLoader(samples, **kw), jds.FragmentLoader(jsamples, **kw)
    assert len(loader) == len(jloader)
    for _ in range(2):
        got, want = list(loader.batches()), list(jloader.batches())
        assert len(got) == len(want) == len(loader)
        for (g, y, w), (jg, jy, jw) in zip(got, want):
            for a, b in zip(g, jg):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(y, jy)
            np.testing.assert_array_equal(w, jw)
    if not drop:
        g, y, w = got[-1]
        assert np.all(w[3:] == 0) and np.all(y[3:, :, 2] == 0)
    with pytest.raises(ValueError):
        ds.FragmentLoader([])


def test_loader_reraises_staging_errors(records):
    samples = list(ds.read_fragments(records))[:8]
    loader = ds.FragmentLoader(samples, pad_to=16, batch_size=4, shuffle=False)
    with pytest.raises(ValueError, match="pad_to"):
        list(loader.batches())


def test_msgpack_writer_round_trips():
    msgpack = pytest.importorskip("msgpack")
    obj = {"a": [1, -1, -33, 200, 70000, 2 ** 40, -2 ** 40, 1.5, None, True, False],
           "s" * 40: "t" * 300, "b": b"\x00" * 70000, "m": {str(i): i for i in range(20)},
           "l": list(range(20))}
    packed = _msgpack.packb(obj)
    assert _msgpack.unpackb(packed) == obj
    assert msgpack.unpackb(packed, raw=False, strict_map_key=False) == obj
    for n in (1, 2, 3, 4, 8, 16, 17, 300, 70000):
        ext = _msgpack.ExtType(1, bytes(range(256)) * (n // 256) + bytes(range(n % 256)))
        assert _msgpack.unpackb(_msgpack.packb(ext)) == ext
    tree = {"x": [np.arange(6, dtype=np.float32).reshape(2, 3), np.ones(2, np.float32)],
            "y": {"z": np.zeros((0,), np.float32)}}
    back = _msgpack.restore_arrays(_msgpack.unpackb(_msgpack.packb(_msgpack.state_dict(tree))))
    np.testing.assert_array_equal(back["x"][0], tree["x"][0])
    np.testing.assert_array_equal(back["x"][1], tree["x"][1])
    assert back["y"]["z"].shape == (0,)
