"""The tiled map over two gloo ranks on the CPU (``ScenePredictor(...,
mesh=)``): each rank maps its strip of tiles, so the two-rank map is
bitwise the one-rank map (tiles of 256: 6 a rank; of 1,024: the ids
padded to 4,096, 2 a rank), and tie-safe equal to JAX's
``ScenePredictor`` on a two-device mesh (its ``shard_map`` over the
tiles): a pixel may differ only where JAX's two best logits are closer
than ``TIE_GAP``, as in ``tests/test_torch_port_slice.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cmlpl_tpu.core.mesh import create_mesh as jax_create_mesh
from cmlpl_tpu.data import prepare_scene as jax_prepare_scene
from cmlpl_tpu.data.patches import gather_patches as jax_gather_patches
from cmlpl_tpu.eval import ScenePredictor as JaxScenePredictor
from cmlpl_tpu.models import BaseNet2 as JaxBaseNet2
from cmlpl_tpu_torch.data.io import synthetic_scene
from cmlpl_tpu_torch.weights import init_basenet2_params
from torch_dist_worker import N_PC, W, run_ranks, task_map
from torch_port_threads import one_torch_thread  # noqa: F401

TIE_GAP = 1e-5
TILES = (256, 1024)


@pytest.fixture(scope="module")
def jax_scene():
    cube, gt = synthetic_scene(0)
    return jax_prepare_scene(0, cube=cube, gt=gt, patch_size=W, n_pc=N_PC)


@pytest.fixture(scope="module")
def mesh2():
    return jax_create_mesh(jax.devices()[:2])


@pytest.fixture(scope="module")
def maps(jax_scene, mesh2, tmp_path_factory):
    params = init_basenet2_params(11, n_pc=N_PC, num_features=103,
                                  num_classes=9, patch_size=W)
    jmodel = JaxBaseNet2(num_features=103, num_classes=9, n_pc=N_PC)

    def apply(p, xp, x):
        return jmodel.apply({"params": p}, xp, x, train=False)[0]

    jmaps = {t: JaxScenePredictor(apply, patch_size=W, cols=jax_scene.cols,
                                  tile=t, gather="xla", mesh=mesh2)(
        params, jax_scene) for t in TILES}

    def jax_gaps(pixels):
        idx = jnp.asarray(pixels, jnp.int32)
        xp = jax_gather_patches(jax_scene.padded_pca, idx,
                                cols=jax_scene.cols, w=W)
        top2 = np.sort(np.asarray(apply(params, xp,
                                        jax_scene.spectra[idx])),
                       axis=-1)[:, -2:]
        return top2[:, 1] - top2[:, 0]

    ranks = run_ranks("map", str(tmp_path_factory.mktemp("map")),
                      tiles=list(TILES))
    return dict(ranks=ranks, one=task_map(None, tiles=TILES), jmaps=jmaps,
                jax_gaps=jax_gaps)


@pytest.mark.parametrize("tile", TILES)
def test_two_rank_map_is_bitwise_the_one_rank_map(maps, tile):
    want = maps["one"][tile]["labels"]
    assert want.shape == (64 * 48,) and want.dtype == np.int32
    for r in maps["ranks"]:
        np.testing.assert_array_equal(r[tile]["labels"], want)


@pytest.mark.parametrize("tile", TILES)
def test_each_rank_maps_its_strip_of_tiles(maps, tile):
    tiles = -(-64 * 48 // (tile * 2)) * 2
    for r in maps["ranks"]:
        assert r[tile]["calls"] == [tile] * (tiles // 2)
    assert maps["one"][tile]["calls"] == [tile] * (-(-64 * 48 // tile))


@pytest.mark.parametrize("tile", TILES)
def test_two_rank_map_matches_the_jax_mesh_map(maps, tile):
    got, want = maps["ranks"][0][tile]["labels"], maps["jmaps"][tile]
    assert got.shape == want.shape
    diff = np.nonzero(got != want)[0]
    if diff.size:
        gaps = maps["jax_gaps"](diff)
        assert (gaps < TIE_GAP).all(), (diff, gaps)
