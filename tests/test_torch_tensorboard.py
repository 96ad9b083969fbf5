"""The port's TensorBoard event writer and reader
(simplesr_tpu_torch/utils/tensorboard.py) against tensorboardX, which the
JAX package writes its scalars with: byte-equal files for the same wall
time, each reader on the other's files, and a corrupt record refused. The
training runs' scalars are held against the JAX package's in
tests/test_torch_training_loop.py."""

import os
import struct
import time
from pathlib import Path

import numpy as np
import pytest
import tensorboardX
import torch

from simplesr_tpu_torch.config import ConfigUtil
from simplesr_tpu_torch.utils import tensorboard
from simplesr_tpu_torch.utils.tensorboard import SummaryWriter, event_files, read_scalars

WALL_TIME = 1760834005.123456
# tags, values and steps as SRModel writes them, and the edge cases of the
# encoding: a zero value and step (proto3 leaves a zero step out), a negative
# step (ten varint bytes), a tag tensorboardX cleans, float32 rounding
SCALARS = [("generator_loss_batch", 0.0123, 50), ("psnr", np.float64(23.456), 1),
           ("ssim", torch.tensor(0.75), 2), ("zero", 0.0, 0), ("neg step", -1.5, -3),
           ("/lead/slash", 1e30, 2 ** 40), ("tiny", np.float32(1e-40), 7)]


def _write_both(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: WALL_TIME)
    port = SummaryWriter(tmp_path / "port")
    ref = tensorboardX.SummaryWriter(str(tmp_path / "tbx"))
    for tag, value, step in SCALARS:
        port.add_scalar(tag, value, step)
        ref.add_scalar(tag, value, step)
    port.close()
    ref.close()
    (ref_file,) = event_files(tmp_path / "tbx")
    return port.path, ref_file


def test_records_are_byte_equal_to_tensorboardx(tmp_path, monkeypatch):
    port_file, ref_file = _write_both(tmp_path, monkeypatch)
    assert os.path.basename(port_file) == ref_file.name  # events.out.tfevents.<s>.<host>
    got, ref = Path(port_file).read_bytes(), ref_file.read_bytes()
    assert got == ref and len(got) > 100


def test_each_reader_reads_the_other(tmp_path, monkeypatch):
    port_file, ref_file = _write_both(tmp_path, monkeypatch)
    want = {tensorboard.clean_tag(tag): [(step, float(np.float32(float(value))))]
            for tag, value, step in SCALARS}
    assert read_scalars(port_file) == read_scalars(ref_file) == want
    assert "lead/slash" in want and "neg_step" in want


def test_records_are_on_disk_as_written_and_files_are_not_reused(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: WALL_TIME)
    first = SummaryWriter(tmp_path)
    first.add_scalar("loss", 0.5, 1)
    assert read_scalars(tmp_path) == {"loss": [(1, 0.5)]}  # before any close or flush
    # a second writer in the same second (a resumed run) takes a new file
    second = SummaryWriter(tmp_path)
    second.add_scalar("loss", 0.25, 2)
    assert second.path == first.path + ".1"
    assert [p.name for p in event_files(tmp_path)] == [os.path.basename(first.path),
                                                       os.path.basename(second.path)]
    assert read_scalars(tmp_path) == {"loss": [(1, 0.5), (2, 0.25)]}
    first.close()
    second.close()
    second.close()  # closing twice is harmless


@pytest.mark.parametrize("where", ["length", "length_crc", "data", "data_crc", "truncated"])
def test_a_corrupt_record_is_refused(tmp_path, where):
    writer = SummaryWriter(tmp_path)
    writer.add_scalar("loss", 0.5, 1)
    writer.close()
    data = bytearray(Path(writer.path).read_bytes())
    first = 12 + struct.unpack("<Q", data[:8])[0] + 4  # the scalar's record starts here
    at = {"length": first + 1, "length_crc": first + 9, "data": first + 14,
          "data_crc": len(data) - 2}.get(where)
    if at is None:
        data = data[:-3]
    else:
        data[at] ^= 0x40
    Path(writer.path).write_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt|truncated"):
        read_scalars(writer.path)


def test_crc32c_check_value():
    assert tensorboard.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    assert tensorboard.crc32c(b"") == 0


def test_config_builds_the_port_writers(tmp_path):
    conf = ConfigUtil.training_config(
        train_data_paths=str(tmp_path), results_save_path=str(tmp_path), num_epochs=1,
        batch_size=1, scale=4, crop_size=(8, 8, 3), num_crops=1)
    writers = [conf.epoch_train_summary_writer, conf.batch_train_summary_writer,
               conf.epoch_validation_summary_writer, conf.batch_validation_summary_writer]
    assert all(isinstance(w, SummaryWriter) for w in writers)
    for writer, d in zip(writers, ("train/epoch", "train/batch", "val/epoch", "val/batch")):
        assert os.path.dirname(writer.path) == os.path.join(conf.save_path, "logs", d)
        assert read_scalars(writer.path) == {}  # the file-version record only
