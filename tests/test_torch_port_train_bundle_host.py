"""The native runner's N-ary mode (``native/aoti_host.cpp --inputs DIR
--outdir DIR``, ``native/aoti_launcher.run_host_io``), the counterpart of
``cmlpl_tpu/native/pjrt_host.cc``'s generic mode (``:430``, ``:580-597``).

A training program's AOTInductor compile takes minutes on this CPU, so
the mode is held here on a small program with the bundle's plumbing: named
inputs and outputs of every dtype a training bundle carries (f32, i32,
u32; 0-d and n-d, the memory bank's (C,) i32 counts among them), a
signature written by ``save_native_bundle``.  The
training bundle itself runs through the runner on the card
(``chip_smoke.py``'s ``train_bundle`` phase).
"""

import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cmlpl_tpu_torch.native.aoti_launcher import build_host, run_host_io
from cmlpl_tpu_torch.utils.export import save_native_bundle

from torch_port_threads import one_torch_thread  # noqa: F401

IN_NAMES = ("state.w", "state.count", "state.rng", "state.bank.count",
            "scale")
OUT_NAMES = ("state.w", "state.count", "state.rng", "state.bank.count",
             "metrics.total")


class Toy(torch.nn.Module):
    def forward(self, w, count, rng, bank_count, scale):
        w = w * scale + 1
        return w, count + 1, rng.clone(), bank_count * 2 + 1, w.sum()


def toy_inputs():
    return {"state.w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "state.count": np.array(7, np.int32),
            "state.rng": np.array([1, 0xFFFFFFFF], np.uint32),
            "state.bank.count": np.array([0, 3, 64, -1, 2 ** 29, 9, 1, 5, 6],
                                         np.int32),
            "scale": np.array(0.5, np.float32)}


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("host")
    inputs = toy_inputs()
    args = tuple(torch.from_numpy(np.array(v)) for v in inputs.values())
    exported = torch.export.export(Toy(), args)
    meta = {"kind": "train_run", "platforms": ["cpu"],
            "compute_dtype": "float32", "input_names": list(IN_NAMES),
            "output_names": list(OUT_NAMES)}
    d = tmp / "bundle"
    save_native_bundle(str(d), meta, exported, in_names=IN_NAMES,
                       out_names=OUT_NAMES)
    (d / "inputs").mkdir()
    for name, value in inputs.items():
        np.save(d / "inputs" / (name + ".npy"), value)
    want = [o.numpy() for o in exported.module()(*args)]
    return {"dir": d, "tmp": tmp, "want": dict(zip(OUT_NAMES, want)),
            "host": build_host()}


def test_signature_names_every_argument(bundle):
    with open(bundle["dir"] / "signature.txt") as f:
        lines = f.read().splitlines()
    assert lines == ["input state.w f32 3,4", "input state.count i32 -",
                     "input state.rng u32 2", "input state.bank.count i32 9",
                     "input scale f32 -",
                     "output state.w f32 3,4", "output state.count i32 -",
                     "output state.rng u32 2",
                     "output state.bank.count i32 9",
                     "output metrics.total f32 -"]


def test_inputs_outdir_writes_every_output(bundle):
    out = bundle["tmp"] / "out"
    line = run_host_io(str(bundle["dir"]), str(bundle["dir"] / "inputs"),
                       str(out), repeat=2, device="cpu")
    assert set(line) == {"load_ms", "run_ms_min", "run_ms_mean", "repeat",
                         "num_inputs", "num_outputs", "device"}
    assert (line["repeat"], line["num_inputs"], line["num_outputs"],
            line["device"]) == (2, 5, 5, "cpu")
    assert 0 < line["run_ms_min"] <= line["run_ms_mean"]
    assert sorted(os.listdir(out)) == sorted(n + ".npy" for n in OUT_NAMES)
    for name, want in bundle["want"].items():
        got = np.load(out / (name + ".npy"))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("fault,match", [
    ("missing", r"cannot open .*state\.count\.npy"),
    ("dtype", r"state\.count\.npy: dtype <f4, signature wants i32"),
    ("unsupported", r"state\.count\.npy: unsupported dtype <i8"),
    ("shape", r"shape 3, signature wants 2 for state\.rng"),
], ids=["missing", "dtype", "unsupported", "shape"])
def test_refuses_a_bad_input(bundle, tmp_path, fault, match):
    inputs = tmp_path / "inputs"
    shutil.copytree(bundle["dir"] / "inputs", inputs)
    if fault == "missing":
        os.remove(inputs / "state.count.npy")
    elif fault == "dtype":
        np.save(inputs / "state.count.npy", np.array(7, np.float32))
    elif fault == "unsupported":
        np.save(inputs / "state.count.npy", np.array(7, np.int64))
    else:
        np.save(inputs / "state.rng.npy", np.zeros(3, np.uint32))
    with pytest.raises(RuntimeError, match=match):
        run_host_io(str(bundle["dir"]), str(inputs), str(tmp_path / "o"),
                    device="cpu")


def test_inputs_and_outdir_go_together(bundle):
    proc = subprocess.run([bundle["host"], "--bundle", str(bundle["dir"]),
                           "--inputs", str(bundle["dir"] / "inputs"),
                           "--device", "cpu"], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 1
    assert "--inputs and --outdir go together" in proc.stderr


def test_launcher_main_takes_the_mode(bundle, capsys):
    from cmlpl_tpu_torch.native import aoti_launcher

    out = bundle["tmp"] / "main_out"
    result = aoti_launcher.main(["--bundle", str(bundle["dir"]), "--inputs",
                                 str(bundle["dir"] / "inputs"), "--outdir",
                                 str(out), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == result
    assert result["num_outputs"] == 5
