"""The native runner (``cmlpl_tpu_torch/native/aoti_host.cpp`` and
``aoti_launcher.py``; ``cmlpl_tpu/native/pjrt_host.cc`` and
``pjrt_launcher.py``) on the CPU.

g++ and libtorch's headers are here, so the runner builds from the repo's
source into the git-ignored ``_build/`` and runs a CPU AOTInductor bundle
of the 64x48 synthetic scene's map (n_pc 16, w 20, tiles of 512), one-shot
and in ``--serve``.  Its labels may differ from JAX's exported map only
where JAX's two best logits are closer than ``TIE_GAP``: Inductor fuses
and sums in another order.  Without a card, ``--device cuda`` fails with
a message; the CUDA bundle runs in ``chip_smoke.py``'s export phase.
"""

import json
import os
import re
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

from cmlpl_tpu.data import prepare_scene as jax_prepare_scene
from cmlpl_tpu.data.patches import gather_patches as jax_gather_patches
from cmlpl_tpu.models import BaseNet2 as JaxBaseNet2
from cmlpl_tpu.utils import export as jax_export
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.data.prep import prepare_scene
from cmlpl_tpu_torch.models.basenet import BaseNet2
from cmlpl_tpu_torch.native import aoti_launcher
from cmlpl_tpu_torch.utils.export import build_exported, save_native_bundle
from cmlpl_tpu_torch.weights import init_basenet2_params, state_dict_from_jax
from torch_port_threads import one_torch_thread  # noqa: F401

N_PC, W, TILE = 16, 20, 512
TIE_GAP = 1e-5


@pytest.fixture(scope="module")
def host_bin():
    return aoti_launcher.build_host()


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A CPU bundle of the tiled map, its inputs as .npy, and JAX's
    exported map of the same weights with its logit gaps."""
    tmp = tmp_path_factory.mktemp("native")
    cube, gt = synthetic_scene(0)
    params = init_basenet2_params(5, n_pc=N_PC, num_features=103,
                                  num_classes=9, patch_size=W)
    scene = prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC,
                          device="cpu")
    model = BaseNet2(num_features=103, num_classes=9, n_pc=N_PC,
                     patch_size=W)
    model.load_state_dict(state_dict_from_jax(params))
    meta, exported = build_exported(model.eval(), None, scene, gather="xla",
                                    tile=TILE)
    save_native_bundle(str(tmp / "b"), meta, exported)

    jscene = jax_prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC)
    jmodel = JaxBaseNet2(num_features=103, num_classes=9, n_pc=N_PC)

    def apply(p, xp, x):
        return jmodel.apply({"params": p}, xp, x, train=False)[0]

    jmeta, payload = jax_export.export_scene_predictor(
        apply, params, jscene, gather="xla", tile=TILE, platforms=["cpu"])
    jax_export.save_exported(str(tmp / "jax.zip"), jmeta, payload)
    _, fn = jax_export.load_exported(str(tmp / "jax.zip"))

    def gaps(pixels):
        idx = jnp.asarray(pixels, jnp.int32)
        xp = jax_gather_patches(jscene.padded_pca, idx, cols=jscene.cols,
                                w=W)
        top2 = np.sort(np.asarray(apply(params, xp, jscene.spectra[idx])),
                       axis=-1)[:, -2:]
        return top2[:, 1] - top2[:, 0]

    np.save(tmp / "cube.npy", scene.padded_pca.numpy())
    np.save(tmp / "spectra.npy", scene.spectra.numpy())
    np.save(tmp / "small.npy", scene.padded_pca.numpy()[:10])
    return dict(tmp=tmp, dir=str(tmp / "b"), meta=meta,
                jax_map=fn(jscene.padded_pca, jscene.spectra), gaps=gaps,
                cube=str(tmp / "cube.npy"), spectra=str(tmp / "spectra.npy"),
                small=str(tmp / "small.npy"))


def assert_tie_safe(labels, bundle):
    want = bundle["jax_map"]
    assert labels.shape == want.shape and labels.dtype == np.int32
    diff = np.nonzero(labels != want)[0]
    if diff.size:
        gaps = bundle["gaps"](diff)
        assert (gaps < TIE_GAP).all(), (diff, gaps)


def test_build_host_builds_into_the_build_dir(host_bin):
    assert os.path.dirname(host_bin) == aoti_launcher.BUILD_DIR
    assert os.access(host_bin, os.X_OK)
    assert re.fullmatch(r"aoti_host_[0-9a-f]{16}", os.path.basename(host_bin))
    assert aoti_launcher.build_host() == host_bin      # built once


def test_build_command_takes_torch_paths_and_abi():
    import torch

    cmd = aoti_launcher.build_command("out")
    root = os.path.dirname(torch.__file__)
    assert os.path.join(root, "include") in cmd
    assert os.path.join(root, "include", "torch", "csrc", "api",
                        "include") in cmd
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    assert f"-D_GLIBCXX_USE_CXX11_ABI={abi}" in cmd
    assert ("-ltorch_cuda" in cmd) == (torch.version.cuda is not None)
    assert any(a.startswith("-std=c++") for a in cmd)


def test_build_failure_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(aoti_launcher, "SRC", str(bad))
    monkeypatch.setattr(aoti_launcher, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        aoti_launcher.build_host()


@pytest.mark.parametrize("arr", [
    np.random.default_rng(0).standard_normal((5, 7, 3)).astype(np.float32),
    np.arange(11, dtype=np.int32),
    np.arange(24, dtype=np.uint8).reshape(4, 6),
    np.float32(2.5).reshape(())], ids=["f32_3d", "i32_1d", "u8_2d", "f32_0d"])
def test_npy_roundtrip_is_bit_exact(host_bin, tmp_path, arr):
    src, dst = str(tmp_path / "a.npy"), str(tmp_path / "b.npy")
    np.save(src, arr)
    out = subprocess.run([host_bin, "--npy_roundtrip", src, dst],
                         capture_output=True, text=True, check=True)
    assert out.stdout.startswith(f"ok {arr.size} elems")
    back = np.load(dst)
    assert back.dtype == arr.dtype and back.shape == arr.shape
    assert back.tobytes() == arr.tobytes()


@pytest.mark.parametrize("arr", [np.zeros((2, 3), np.float64),
                                 np.asfortranarray(np.zeros((2, 3),
                                                            np.float32))],
                         ids=["f64", "fortran"])
def test_npy_reader_refuses_what_it_cannot_read(host_bin, tmp_path, arr):
    src = str(tmp_path / "a.npy")
    np.save(src, arr)
    out = subprocess.run([host_bin, "--npy_roundtrip", src,
                          str(tmp_path / "b.npy")], capture_output=True,
                         text=True)
    assert out.returncode == 1
    assert "unsupported" in out.stderr


def test_bundle_files(bundle):
    assert sorted(os.listdir(bundle["dir"])) == ["meta.json", "model.pt2",
                                                 "signature.txt"]
    with open(os.path.join(bundle["dir"], "meta.json")) as f:
        assert json.load(f) == bundle["meta"]


def test_dump_signature_equals_the_bundle(host_bin, bundle):
    out = subprocess.run([host_bin, "--dump_signature", bundle["dir"]],
                         capture_output=True, text=True, check=True)
    with open(os.path.join(bundle["dir"], "signature.txt")) as f:
        written = f.read()
    assert out.stdout == written
    hp, wp, c = bundle["meta"]["cube_shape"]
    k, bands = bundle["meta"]["spectra_shape"]
    assert written.splitlines() == [
        f"input padded_cube f32 {hp},{wp},{c}",
        f"input spectra f32 {k},{bands}", f"output labels i32 {k}"]


def test_one_shot_matches_the_jax_map(bundle):
    out = str(bundle["tmp"] / "one_shot.npy")
    result = aoti_launcher.run_host(bundle["dir"], bundle["cube"],
                                    bundle["spectra"], out, repeat=2,
                                    device="cpu")
    assert set(result) == {"load_ms", "run_ms_min", "run_ms_mean", "repeat",
                           "device"}
    assert result["repeat"] == 2 and result["device"] == "cpu"
    assert 0 < result["run_ms_min"] <= result["run_ms_mean"]
    assert_tie_safe(np.load(out), bundle)


def test_serve_survives_bad_requests(host_bin, bundle):
    outs = [str(bundle["tmp"] / f"s{i}.npy") for i in range(5)]
    good = f"{bundle['cube']} {bundle['spectra']}"
    reqs = [f"{good} {outs[0]}", f"{bundle['small']} {bundle['spectra']} "
            f"{outs[1]}", "only two", f"{good} {outs[2]}",
            f"{bundle['tmp'] / 'missing.npy'} {bundle['spectra']} {outs[3]}",
            f"{good} {outs[4]}", "", "after the blank line"]
    proc = subprocess.run([host_bin, "--bundle", bundle["dir"], "--serve"],
                          input="\n".join(reqs) + "\n", capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert [ln.split()[0] for ln in lines] == ["ok", "error", "error", "ok",
                                               "error", "ok"]
    assert "shape 10," in lines[1] and "signature wants" in lines[1]
    assert "bad request" in lines[2]
    assert "cannot open" in lines[4]
    for i, line in zip((0, 2, 4), (lines[0], lines[3], lines[5])):
        _, path, ms = line.split()
        assert path == outs[i] and float(ms) > 0
        assert_tie_safe(np.load(outs[i]), bundle)
    np.testing.assert_array_equal(np.load(outs[0]), np.load(outs[4]))


def test_device_cuda_without_a_card_fails_with_a_message(host_bin, bundle):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this test holds the refusal where there is no card")
    proc = subprocess.run([host_bin, "--bundle", bundle["dir"], "--cube",
                           bundle["cube"], "--spectra", bundle["spectra"],
                           "--out", str(bundle["tmp"] / "x.npy"), "--device",
                           "cuda"], capture_output=True, text=True)
    assert proc.returncode == 1
    assert "--device cuda: CUDA is not available" in proc.stderr
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        aoti_launcher.run_host(bundle["dir"], bundle["cube"],
                               bundle["spectra"],
                               str(bundle["tmp"] / "x.npy"))


@pytest.mark.parametrize("library,message", [
    (None, "calls cmlpl::gather_patches_f32: pass --op_library"),
    ("missing.so", "cannot load --op_library"),
    ("libc10.so", "registers no cmlpl::gather_patches_f32")],
    ids=["no_library", "missing_library", "library_without_the_op"])
def test_bundle_with_custom_ops_needs_their_library(host_bin, bundle,
                                                    tmp_path, library,
                                                    message):
    """A bundle whose meta names custom operators (a kernel gather's run
    program) runs only once the library that registers them is loaded:
    without it, or with one that registers another, the runner fails
    before it loads the package, naming what is missing."""
    import shutil

    import torch

    copy = tmp_path / "b"
    shutil.copytree(bundle["dir"], copy)
    meta = dict(bundle["meta"], custom_ops=["cmlpl::gather_patches_f32"])
    (copy / "meta.json").write_text(json.dumps(meta, indent=1))
    argv = [host_bin, "--bundle", str(copy), "--cube", bundle["cube"],
            "--spectra", bundle["spectra"], "--out", str(tmp_path / "x.npy"),
            "--device", "cpu"]
    if library == "libc10.so":
        library = os.path.join(os.path.dirname(torch.__file__), "lib",
                               library)
    elif library is not None:
        library = str(tmp_path / library)
    if library is not None:
        argv += ["--op_library", library]
    proc = subprocess.run(argv, capture_output=True, text=True)
    assert proc.returncode == 1
    assert message in proc.stderr
    assert not (tmp_path / "x.npy").exists()


def test_launcher_main_prints_the_result(bundle, capsys):
    out = str(bundle["tmp"] / "main.npy")
    result = aoti_launcher.main(["--bundle", bundle["dir"], "--cube",
                                 bundle["cube"], "--spectra",
                                 bundle["spectra"], "--out", out,
                                 "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == result
    assert_tie_safe(np.load(out), bundle)


def test_runner_source_stands_alone():
    """The runner includes libtorch and the standard library only: nothing
    of the JAX package and no PJRT header."""
    with open(aoti_launcher.SRC) as f:
        includes = re.findall(r'^#include [<"]([^>"]+)[>"]', f.read(), re.M)
    assert includes
    for inc in includes:
        assert "cmlpl_tpu" not in inc and "pjrt" not in inc.lower(), inc
        assert inc.startswith(("ATen/", "torch/")) or "/" not in inc, inc


def test_the_isolation_scan_sees_the_new_modules():
    import test_torch_port_isolation as iso

    names = {p.relative_to(iso.ROOT).as_posix() for p in iso.FILES}
    assert {"cmlpl_tpu_torch/utils/export.py",
            "cmlpl_tpu_torch/cli/export_model.py",
            "cmlpl_tpu_torch/native/aoti_launcher.py",
            "cmlpl_tpu_torch/native/__init__.py"} <= names
