"""The port's Data breadth: the TFRecord codec and the image / TFRecord /
webdataset datasources, the cases of tests/test_data_breadth.py on
``ray_tpu_torch.data`` (its chaos ingest case is in
tests/test_torch_data_cluster.py, beside the other cluster case)."""

import tarfile

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data
from torch_port_util import deadline, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def runtime():
    info = ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield info
    ray_tpu_torch.shutdown()


class TestTFRecordCodec:
    def test_record_framing_roundtrip(self, tmp_path):
        from ray_tpu_torch.data.tfrecord import read_records, write_records

        path = str(tmp_path / "x.tfrecords")
        payloads = [b"hello", b"", b"\x00" * 100, b"world" * 50]
        write_records(path, payloads)
        assert read_records(path) == payloads

    def test_crc_detects_corruption(self, tmp_path):
        from ray_tpu_torch.data.tfrecord import read_records, write_records

        path = str(tmp_path / "x.tfrecords")
        write_records(path, [b"payload-data"])
        raw = bytearray(open(path, "rb").read())
        raw[14] ^= 0xFF  # flip a payload byte
        open(path, "wb").write(bytes(raw))
        with pytest.raises(ValueError, match="crc"):
            read_records(path)

    def test_example_codec_roundtrip(self):
        from ray_tpu_torch.data.tfrecord import decode_example, encode_example

        ex = {"label": 7, "weights": [0.5, -1.25, 3.0],
              "name": "sample-1", "raw": b"\x01\x02\x03",
              "ids": [1, 2, 300000, -5]}
        got = decode_example(encode_example(ex))
        assert got["label"] == [7]
        assert got["ids"] == [1, 2, 300000, -5]
        assert got["name"] == [b"sample-1"]
        assert got["raw"] == [b"\x01\x02\x03"]
        np.testing.assert_allclose(got["weights"], [0.5, -1.25, 3.0],
                                   rtol=1e-6)


class TestDatasources:
    @deadline(60)
    def test_read_tfrecords(self, runtime, tmp_path):
        from ray_tpu_torch.data.tfrecord import encode_example, write_records

        for shard in range(2):
            write_records(
                str(tmp_path / f"part-{shard}.tfrecords"),
                [encode_example({"label": shard * 4 + i,
                                 "text": f"row{shard * 4 + i}"})
                 for i in range(4)])
        ds = data.read_tfrecords(str(tmp_path))
        rows = ds.take_all()
        assert sorted(r["label"] for r in rows) == list(range(8))
        assert {bytes(r["text"]).decode() for r in rows} == \
            {f"row{i}" for i in range(8)}

    @deadline(60)
    def test_read_images_resize_and_mode(self, runtime, tmp_path):
        from PIL import Image

        for i in range(3):
            arr = np.full((12 + i, 10, 3), i * 40, np.uint8)
            Image.fromarray(arr).save(tmp_path / f"img-{i}.png")
        ds = data.read_images(str(tmp_path), size=(8, 8), mode="L")
        rows = ds.take_all()
        assert len(rows) == 3
        for r in rows:
            assert np.asarray(r["image"]).shape == (8, 8)

    @deadline(60)
    def test_read_webdataset(self, runtime, tmp_path):
        import io
        import json

        from PIL import Image

        shard = tmp_path / "shard-000.tar"
        with tarfile.open(shard, "w") as tar:
            for i in range(4):
                img = np.full((6, 6, 3), i, np.uint8)
                buf = io.BytesIO()
                Image.fromarray(img).save(buf, format="PNG")
                for ext, payload in (
                        ("png", buf.getvalue()),
                        ("cls", str(i % 2).encode()),
                        ("json", json.dumps({"idx": i}).encode())):
                    info = tarfile.TarInfo(f"sample{i}.{ext}")
                    data_bytes = payload
                    info.size = len(data_bytes)
                    tar.addfile(info, io.BytesIO(data_bytes))
        rows = data.read_webdataset(str(shard)).take_all()
        assert len(rows) == 4
        for i, r in enumerate(sorted(rows, key=lambda r: r["__key__"])):
            assert r["__key__"] == f"sample{i}"
            assert np.asarray(r["png"]).shape == (6, 6, 3)
            assert r["cls"] == i % 2
            assert r["json"]["idx"] == i
