"""The port's read-only HDF5 reader (``train/_hdf5.py``) against h5py: every
group, dataset and attribute of files h5py writes by default and with
newer ``libver`` bounds (superblocks 0, 2 and 3, object headers 1 and 2, symbol
tables and compact links, continuation blocks, contiguous and compact
datasets, fixed- and variable-length strings, both byte orders), a Keras
file saved by tf_keras itself (committed, so that no test needs TensorFlow),
and the refusals by name:
chunked and filtered datasets and dense (fractal heap) link storage."""

from pathlib import Path

import h5py
import numpy as np
import pytest

from _h5_compare import assert_same as _assert_same
from simplesr_tpu_torch.train import _hdf5

ROOT = Path(__file__).resolve().parents[1]


def _fill(f, rng, latest):
    f.attrs["keras_version"] = b"2.15.0"
    f.attrs["model_config"] = '{"class_name": "Functional"}'
    f.attrs["names"] = np.array([b"conv2d", b"p_re_lu_12", b"add"])
    f.attrs["text"] = ["one", "two", "three"]
    f.attrs["empty"] = np.array([], dtype="S1")
    f.attrs["scalar"] = np.float64(2.5)
    f.attrs["big_endian"] = np.arange(4, dtype=">i4")
    arrays = f.create_group("arrays")  # 8 links: compact storage under latest
    arrays.create_dataset("f16", data=rng.normal(size=(3, 5)).astype(np.float16))
    arrays.create_dataset("f64_be", data=rng.normal(size=7).astype(">f8"))
    arrays.create_dataset("i8", data=rng.integers(-100, 100, (2, 2, 2)).astype(np.int8))
    arrays.create_dataset("u16", data=rng.integers(0, 60000, 9).astype(np.uint16))
    arrays.create_dataset("scalar", data=np.float32(1.25))
    arrays.create_dataset("strings", data=np.array([b"ab", b"cde"]))
    arrays.create_dataset("vstrings", data=["x", "yy"], dtype=h5py.string_dtype())
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    space = h5py.h5s.create_simple((6,))
    h5py.h5d.create(arrays.id, b"compact", h5py.h5t.NATIVE_INT32, space, dcpl=dcpl).write(
        h5py.h5s.ALL, h5py.h5s.ALL, np.arange(6, dtype=np.int32))
    for g in range(3 if latest else 20):
        group = f.create_group(f"layer_{g}")
        group.attrs["weight_names"] = np.array([f"layer_{g}/kernel:0".encode()])
        group.create_dataset(f"layer_{g}/kernel:0",
                             data=rng.normal(size=(3, 3, 2, 4)).astype(np.float32))
    # attributes added last spill the root's object header into a
    # continuation block (at most 8 in all: more go to dense storage)
    for k in range(1 if latest else 6):
        f.attrs[f"pad_{k}"] = np.full(700, k, np.float32) if k % 2 == 0 else "x" * 500


@pytest.mark.parametrize("libver,superblock", [("earliest", 0), ("v108", 2), ("latest", 3)])
def test_files_read_as_h5py_reads_them(tmp_path, libver, superblock):
    path = tmp_path / f"{libver}.h5"
    with h5py.File(path, "w", libver=(libver, "latest")) as f:
        _fill(f, np.random.default_rng(0), latest=libver != "earliest")
    assert path.read_bytes()[8] == superblock
    with _hdf5.File(path) as mine, h5py.File(path, "r") as ref:
        _assert_same(mine, ref)
        assert "layer_1/layer_1/kernel:0" in mine and "nothing" not in mine


def test_user_block_and_deep_symbol_tables(tmp_path):
    """A 512-byte user block before the superblock, and a group of 300
    members, whose symbol-table B-tree has internal nodes."""
    path = tmp_path / "deep.h5"
    rng = np.random.default_rng(1)
    with h5py.File(path, "w", userblock_size=512) as f:
        for i in range(300):
            f.create_dataset(f"d{i:03d}", data=rng.normal(size=2).astype(np.float32))
    with _hdf5.File(path) as mine, h5py.File(path, "r") as ref:
        _assert_same(mine, ref)


@pytest.mark.parametrize("make,what", [
    (lambda f: f.create_dataset("c", data=np.zeros((4, 4)), chunks=(2, 2)), "chunked"),
    (lambda f: f.create_dataset("z", data=np.zeros(64), compression="gzip"), "filtered"),
])
def test_chunked_and_filtered_datasets_are_refused(tmp_path, make, what):
    path = tmp_path / "r.h5"
    with h5py.File(path, "w") as f:
        make(f)
    with _hdf5.File(path) as mine:
        with pytest.raises(ValueError, match=what):
            next(iter(mine[k] for k in mine.keys()))[()]


def test_dense_link_storage_is_refused(tmp_path):
    path = tmp_path / "dense.h5"
    with h5py.File(path, "w", libver="latest") as f:
        for i in range(20):
            f.create_group(f"g{i}")
    with pytest.raises(ValueError, match="dense link storage"):
        _hdf5.File(path)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        (tmp_path / "x.h5").write_bytes(b"\x89PNG" + bytes(100))
        _hdf5.File(tmp_path / "x.h5")


KERAS_FILE = ROOT / "data/corpus/keras_h5/srresnet_x2_bn.h5"


def test_a_file_keras_saved_reads_as_h5py_and_imports():
    """An SRResNet x2 in the reference's layer order (BatchNorm, 2 blocks),
    saved by tf_keras itself (data/corpus/keras_h5/MANIFEST.json has its
    recipe), read as h5py reads it and imported as the JAX importer
    imports it."""
    path = KERAS_FILE
    with _hdf5.File(path) as mine, h5py.File(path, "r") as ref:
        _assert_same(mine, ref)
    from simplesr_tpu.tools.import_keras import import_keras_model as jax_import
    from simplesr_tpu_torch.tools.import_keras import import_keras_model
    config, variables = import_keras_model(path)
    jax_config, jax_variables = jax_import(str(path))
    assert config == jax_config and config["batch_norm"] and config["num_blocks"] == 2
    flat = lambda t, p="": {f"{p}/{k}": v for k, s in t.items()  # noqa: E731
                            for k, v in (flat(s, f"{p}/{k}").items() if isinstance(s, dict)
                                         else [(k, s)])}
    ours, theirs = flat(variables), flat(jax_variables)
    assert ours.keys() == theirs.keys()
    for key in ours:
        np.testing.assert_array_equal(ours[key], np.asarray(theirs[key]))
