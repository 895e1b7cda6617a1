"""var_tpu_torch/utils/tb_writer.py, kvlogger.py and misc.py against their
var_tpu twins on the CPU.

Tolerances: none. The event files are byte-identical at a pinned wall
time (both writers frame the same protobuf bytes with the same CRCs); the
logger's stdout, CSV, JSONL and event files are identical; the utilities
return the same values.
"""
import os
import pickle

import numpy as np
import pytest

from var_tpu.utils import kvlogger as jkv
from var_tpu.utils import misc as jmisc
from var_tpu.utils import tb_writer as jtb
from var_tpu_torch.utils import kvlogger as tkv
from var_tpu_torch.utils import misc as tmisc
from var_tpu_torch.utils import tb_writer as ttb

WALL = 1_700_000_000.25  # the pinned wall time


@pytest.fixture
def pinned_time(monkeypatch):
    for mod in (jtb, ttb, jkv, tkv):
        monkeypatch.setattr(mod.time, "time", lambda: WALL)


def test_crc32c_and_varints_match():
    rng = np.random.RandomState(0)
    for n in (0, 1, 7, 64, 1000):
        data = rng.randint(0, 256, n).astype(np.uint8).tobytes()
        assert ttb.crc32c(data) == jtb.crc32c(data)
        assert ttb.masked_crc(data) == jtb.masked_crc(data)
    # the CRC-32C check value of "123456789"
    assert ttb.crc32c(b"123456789") == 0xE3069283
    for v in (0, 1, 127, 128, 300, 2 ** 35, 2 ** 64 - 1):
        assert ttb._varint(v) == jtb._varint(v)
    np.testing.assert_array_equal(ttb._TABLE, jtb._TABLE)


def test_event_files_are_byte_identical(tmp_path, pinned_time):
    steps = [(0, {"loss": 1.5, "lr": 3e-4}),
             (1, {"loss": np.float32(0.25), "n": np.int64(7), "s": "skip"}),
             (10 ** 9, {"neg": -2.0})]
    files = []
    for mod, name in ((jtb, "jax"), (ttb, "port")):
        w = mod.EventFileWriter(str(tmp_path / name), filename_suffix=".x")
        for step, scalars in steps:
            w.add_scalars(step, scalars, wall_time=WALL + step)
        w.add_scalars(2, {"only": "text"})  # nothing numeric: no record
        w.close()
        files.append(w.path)
    assert os.path.basename(files[0]) == os.path.basename(files[1])
    data = [open(p, "rb").read() for p in files]
    assert data[0] == data[1]
    got = ttb.read_events(files[1])
    assert got == jtb.read_events(files[0])
    assert got[0] == (WALL, None, {})
    assert [s for _, s, _ in got[1:]] == [0, 1, 10 ** 9]
    assert got[2][2] == {"loss": 0.25, "n": 7.0}
    assert ttb.encode_event(WALL, 3, {"a": 1.0}, "brain.Event:2") == \
        jtb.encode_event(WALL, 3, {"a": 1.0}, "brain.Event:2")


def test_kvlogger_writes_what_jax_writes(tmp_path, pinned_time, capsys):
    outs = {}
    for mod, name in ((jkv, "jax"), (tkv, "port")):
        log = mod.KVLogger(str(tmp_path / name),
                           formats=["stdout", "csv", "json", "tensorboard"])
        for i in range(3):
            log.logkv("nupdates", i)
            log.logkv("loss", 1.0 / (i + 1))
            log.logkv_mean("fps", 100.0 + i)
            log.logkv_mean("fps", 110.0 + i)
            if i == 1:
                log.logkv("late_key", 5)  # widens the CSV
            with log.profile_kv("step"):
                pass
            dumped = log.dumpkvs()
            dumped.pop("wait_step")  # a timing: not compared
        outs[name] = capsys.readouterr().out
        assert dumped["fps"] == pytest.approx(107.0)  # (102 + 112) / 2
    strip = lambda s: [l for l in s.splitlines() if "wait_step" not in l]  # noqa: E731
    assert strip(outs["jax"]) == strip(outs["port"])
    for fname in ("progress_kv.csv", "progress.jsonl"):
        rows = [open(tmp_path / n / fname).read().splitlines()
                for n in ("jax", "port")]
        assert len(rows[0]) == len(rows[1]) > 0
        for a, b in zip(*rows):
            assert _drop_timing(a) == _drop_timing(b), fname
    tb = [sorted(os.listdir(tmp_path / n / "tb")) for n in ("jax", "port")]
    assert tb[0] == tb[1]
    events = [ttb.read_events(str(tmp_path / n / "tb" / tb[0][0]))
              for n in ("jax", "port")]
    for a, b in zip(*events):
        assert a[:2] == b[:2]
        assert {k: v for k, v in a[2].items() if k != "wait_step"} == \
            {k: v for k, v in b[2].items() if k != "wait_step"}
    assert [e[1] for e in events[1][1:]] == [0, 1, 2]


def _drop_timing(line):
    """A CSV or JSONL row without its wait_step value (a timing)."""
    import json

    if line.startswith("{"):
        d = json.loads(line)
        d.pop("wait_step", None)
        return d
    return line.split(",")


def test_misc_matches(tmp_path, monkeypatch):
    class A:
        pass

    a = A()
    a.b = A()
    a.b.c = 42
    assert tmisc.rgetattr(a, "b.c") == jmisc.rgetattr(a, "b.c") == 42
    assert tmisc.rgetattr(a, "b.x", 0) == jmisc.rgetattr(a, "b.x", 0) == 0
    with pytest.raises(AttributeError):
        tmisc.rgetattr(a, "b.x")
    assert tmisc.confirm_from_user("go?", assume_yes=True)
    answers = iter(["maybe", "N"])
    monkeypatch.setattr("builtins.input", lambda *_: next(answers))
    assert tmisc.confirm_from_user("go?") is False
    monkeypatch.setenv("VAR_TPU_ASSUME_YES", "1")
    assert tmisc.confirm_from_user("go?") is True
    for mod, name in ((jmisc, "jax"), (tmisc, "port")):
        path = tmp_path / f"{name}.pickle"
        with open(path, "wb") as f:
            pickle.dump({"x": np.arange(3)}, f, protocol=4)
        mod.convert_pickle_protocol(str(tmp_path / f"{name}.pickle"), 2)
    data = [open(tmp_path / f"{n}.pickle", "rb").read()
            for n in ("jax", "port")]
    assert data[0] == data[1] and data[0][:2] == b"\x80\x02"
