"""The port's HDF5 writer (``train/_hdf5_write.py``) against h5py and the
port's own reader: every group, dataset and attribute it writes (float32
datasets, variable-length strings and lists of them, the empty list, a
variable-length string over the 64 KB message limit, groups deep enough for
a B-tree of more than one level) reads back equal through both, the same
tree gives the same bytes, and what it cannot write is refused by name."""

import h5py
import numpy as np
import pytest

from _h5_compare import assert_same
from simplesr_tpu_torch.train import _hdf5, _hdf5_write


def _tree(rng, groups):
    root = _hdf5_write.Group()
    root.attrs["keras_version"] = "2.21.0"
    root.attrs["model_config"] = ('{"layers": [' + ", ".join(
        f'"layer_{i}"' for i in range(12000)) + "]}").encode()  # ~140 KB
    root.attrs["text"] = ["one", "twö", ""]
    root.attrs["names"] = [b"conv2d", b"p_re_lu_12", b"tf.nn.depth_to_space"]
    root.attrs["empty"] = []
    arrays = root.create_group("arrays")
    arrays.create_dataset("f32", rng.normal(size=(3, 3, 2, 4)).astype(np.float32))
    arrays.create_dataset("scalar", np.float32(1.25))
    arrays.create_dataset("none", np.zeros((0, 5), np.float32))
    weights = root.create_group("model_weights")
    for g in range(groups):
        group = weights.create_group(f"layer_{g}")
        group.attrs["weight_names"] = [f"layer_{g}/kernel:0".encode()] if g % 3 else []
        if g % 3:
            group.create_dataset(f"layer_{g}/kernel:0",
                                 rng.normal(size=(2, 3)).astype(np.float32))
    return root


# 5 groups: one symbol-table node; 700: 88 nodes under a two-level B-tree
@pytest.mark.parametrize("groups", [5, 700])
def test_files_read_back_through_h5py_and_the_port(tmp_path, groups):
    path = tmp_path / "w.h5"
    _hdf5_write.write_file(path, _tree(np.random.default_rng(0), groups))
    assert path.read_bytes()[8] == 0  # superblock version 0
    with _hdf5.File(path) as mine, h5py.File(path, "r") as ref:
        assert len(ref.attrs["model_config"]) > 65535
        assert h5py.check_string_dtype(ref.attrs.get_id("model_config").dtype).length is None
        assert len(ref["model_weights"]) == groups
        assert_same(mine, ref)


def test_the_same_tree_gives_the_same_bytes(tmp_path):
    for name in ("a.h5", "b.h5"):
        _hdf5_write.write_file(tmp_path / name, _tree(np.random.default_rng(1), 20))
    assert (tmp_path / "a.h5").read_bytes() == (tmp_path / "b.h5").read_bytes()


def test_what_is_not_written_is_refused(tmp_path):
    root = _hdf5_write.Group()
    for data in (np.arange(3), np.zeros(3), np.zeros(3, ">f4")):
        with pytest.raises(ValueError, match="datasets of"):
            root.create_dataset("x", data)
    root.create_group("g")
    with pytest.raises(ValueError, match="exists"):
        root.create_group("g")
    for value in (np.arange(3), np.float32(1), ["a", b"b"]):
        root.attrs["x"] = value
        with pytest.raises(ValueError, match="attributes other than"):
            _hdf5_write.write_file(tmp_path / "x.h5", root)
    # an attribute whose object-header message would pass 64 KB
    root = _hdf5_write.Group()
    root.attrs["big"] = [b"x"] * 5000  # 16 bytes of header each: 80 KB
    with pytest.raises(ValueError, match="'big'.*65535"):
        _hdf5_write.write_file(tmp_path / "z.h5", root)
