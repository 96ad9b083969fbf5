"""The port's HDF5 reader against h5py on one file: the same groups,
datasets and attributes, of the same types, dtypes, shapes and values."""

import h5py
import numpy as np

from simplesr_tpu_torch.train import _hdf5


def assert_same(got, want):
    """``got`` (the port's reader) holds what ``want`` (h5py) holds."""
    if isinstance(want, h5py.Dataset):
        assert isinstance(got, _hdf5.Dataset)
        a, b = got[()], want[()]
        assert type(a) is type(b) and np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).shape == np.asarray(b).shape == got.shape
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert isinstance(got, _hdf5.Group) and sorted(got.keys()) == sorted(want.keys())
        for name in want:
            assert_same(got[name], want[name])
    assert sorted(got.attrs) == sorted(want.attrs)
    for name, value in want.attrs.items():
        mine = got.attrs[name]
        assert type(mine) is type(value), name
        if isinstance(value, np.ndarray):
            assert mine.dtype == value.dtype and mine.shape == value.shape
        np.testing.assert_array_equal(np.asarray(mine), np.asarray(value))
