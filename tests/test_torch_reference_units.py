"""PyTorch port: the reference's own unit tests against the port's
``metric.py``, the mirror of tests/test_reference_units.py (reference
tests/unit/test_metric.py: test_default_error_vector :30-49,
test_default_euclidean_distance :52-70, placeholders :73-198).

Each case runs the port's metric on float64 CPU tensors and the JAX
package's on the same values: the port holds the reference's numbers and
equals the JAX package's. No JAX program is compiled beyond eager ops on
a few values.
"""
import numpy as np
import pytest
import torch

from open_pcc_metric_tpu_torch import metric as pm

from test_torch_refine import jax_on_cpu


def _jax_metric():
    jax_on_cpu()
    from open_pcc_metric_tpu import metric as jm

    return jm


def _set(metric, values):
    metric.value = torch.as_tensor(np.asarray(values, dtype=np.float64))
    return metric


def _jset(metric, values):
    import jax.numpy as jnp

    metric.value = jnp.asarray(values, dtype=jnp.float64)
    return metric


class TestErrorVector:
    def test_unit_error_vectors_have_sqrt3_norm(self):
        # All-ones error vectors: per-point L2 norm sqrt(3) (the
        # reference's only real assertion).
        pev = _set(pm.PrimaryErrorVector(is_left=True), np.ones((7, 3)))
        m = pm.ErrorVector(is_left=True, point_to_plane=False)
        m.calculate(primary_error_vector=pev)
        np.testing.assert_allclose(m.value.numpy(), np.sqrt(3.0), rtol=1e-12)
        jm = _jax_metric()
        jpev = _jset(jm.PrimaryErrorVector(is_left=True), np.ones((7, 3)))
        want = jm.ErrorVector(is_left=True, point_to_plane=False)
        want.calculate(primary_error_vector=jpev)
        np.testing.assert_array_equal(m.value.numpy(), np.asarray(want.value))

    def test_point_to_plane_projects_onto_normals(self):
        # The part the reference stubbed out: error (1, 1, 1) onto (0, 0, 1)
        # is 1, onto (1, 0, 0) 1, onto normalised (1, 1, 1) sqrt(3).
        err = np.ones((3, 3))
        normals = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0],
                            [1 / np.sqrt(3)] * 3])
        pev = _set(pm.PrimaryErrorVector(is_left=True), err)
        nrm = _set(pm.CloudNormals(is_left=False), normals)
        m = pm.ErrorVector(is_left=True, point_to_plane=True)
        m.calculate(primary_error_vector=pev, cloud_normals=nrm)
        np.testing.assert_allclose(m.value.numpy(), [1.0, 1.0, np.sqrt(3.0)],
                                   rtol=1e-12)
        jm = _jax_metric()
        want = jm.ErrorVector(is_left=True, point_to_plane=True)
        want.calculate(
            primary_error_vector=_jset(jm.PrimaryErrorVector(is_left=True),
                                       err),
            cloud_normals=_jset(jm.CloudNormals(is_left=False), normals))
        np.testing.assert_allclose(m.value.numpy(), np.asarray(want.value),
                                   rtol=1e-15)


class TestEuclideanDistance:
    @pytest.mark.parametrize("is_left", [True, False])
    def test_p2point_passthrough_of_squared_distances(self, is_left):
        nd = _set(pm.NeighbourDistances(is_left=is_left), [4.0, 9.0, 16.0])
        m = pm.EuclideanDistance(is_left=is_left, point_to_plane=False)
        m.calculate(neighbour_distances=nd)
        np.testing.assert_array_equal(m.value.numpy(), [4.0, 9.0, 16.0])

    def test_p2plane_squares_projection(self):
        ev = _set(pm.ErrorVector(is_left=True, point_to_plane=True),
                  [-2.0, 3.0])
        m = pm.EuclideanDistance(is_left=True, point_to_plane=True)
        m.calculate(error_vector=ev)
        np.testing.assert_array_equal(m.value.numpy(), [4.0, 9.0])


class TestGeoChain:
    def test_mse_then_psnr(self):
        ed = _set(pm.EuclideanDistance(is_left=True, point_to_plane=False),
                  [1.0, 2.0, 3.0, 6.0])
        mse = pm.GeoMSE(is_left=True, point_to_plane=False)
        mse.calculate(euclidean_distance=ed)
        assert mse.value == 3.0

        class _Extent:
            value = np.array([10.0, 4.0, 2.0])

        psnr = pm.GeoPSNR(is_left=True, point_to_plane=False)
        psnr.calculate(cloud_extent=_Extent(), geo_mse=mse)
        np.testing.assert_allclose(psnr.value, 10 * np.log10(100.0 / 3.0),
                                   rtol=1e-12)
        jm = _jax_metric()
        jmse = jm.GeoMSE(is_left=True, point_to_plane=False)
        jmse.calculate(euclidean_distance=_jset(
            jm.EuclideanDistance(is_left=True, point_to_plane=False),
            [1.0, 2.0, 3.0, 6.0]))
        jpsnr = jm.GeoPSNR(is_left=True, point_to_plane=False)
        jpsnr.calculate(cloud_extent=_Extent(), geo_mse=jmse)
        assert float(mse.value) == float(jmse.value)
        np.testing.assert_allclose(psnr.value, float(jpsnr.value), rtol=1e-15)
