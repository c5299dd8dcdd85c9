"""The port's small modules that no render path uses, against the JAX
package on the same inputs: ``mat3`` (twins of tests/test_maths.py's
TestMat3, the reference's hand-computed cases mat3.rs:145-244), ``maths.
project`` (maths.rs:259-269), ``color``, ``intersect.
closest_hit_batch_argmin`` and ``utils.profiling.trace``."""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu import color as jcolor
from raytracer_tpu import intersect as jintersect
from raytracer_tpu import mat3 as jmat3
from raytracer_tpu import maths as jmaths
import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import color, intersect, mat3, maths
from raytracer_tpu_torch.utils import profiling


def m(rows):
    return torch.tensor(rows, dtype=torch.float32)


def vec(x, y, z):
    return torch.tensor([x, y, z], dtype=torch.float32)


def assert_near(a, b, tol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol)


def assert_twin(got, jax_fn, *args):
    """``got`` (the port's result) equals the JAX function's on the same
    inputs, to float32 rounding."""
    want = jax_fn(*(jnp.asarray(np.asarray(a)) for a in args))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


class TestMat3:
    A = [[1, 2, 3], [4, 5, 6], [7, 8, 9]]

    def test_identity_mul(self):
        # mat3.rs:153-164
        a = m(self.A)
        assert_near(mat3.mul(a, mat3.identity()), a)
        assert_near(mat3.mul(mat3.identity(), a), a)

    def test_general_mul(self):
        # mat3.rs:166-180 style: hand-checked product
        a, b = m(self.A), m([[9, 8, 7], [6, 5, 4], [3, 2, 1]])
        assert_near(mat3.mul(a, b),
                    [[30, 24, 18], [84, 69, 54], [138, 114, 90]])
        assert_twin(mat3.mul(a, b), jmat3.mul, a, b)

    def test_transpose(self):
        a = m(self.A)
        assert_near(mat3.transpose(a), a.T)
        assert_near(mat3.transpose(mat3.transpose(a)), a)

    def test_det(self):
        assert abs(float(mat3.det(mat3.identity())) - 1.0) < 1e-6
        assert abs(float(mat3.det(m([[2, 0, 0], [0, 3, 0], [0, 0, 4]])))
                   - 24.0) < 1e-5
        assert abs(float(mat3.det(m(self.A)))) < 1e-4

    def test_cofactor_adjugate(self):
        a = m([[1, 2, 0], [0, 1, 3], [4, 0, 1]])
        adj = mat3.adjugate(a)
        # A * adj(A) == det(A) * I
        assert_near(mat3.mul(a, adj), float(mat3.det(a)) * np.eye(3),
                    tol=1e-4)
        assert_twin(mat3.cofactor(a), jmat3.cofactor, a)
        assert_twin(adj, jmat3.adjugate, a)

    def test_inverse(self):
        a = m([[2, 1, 0], [1, 3, 1], [0, 1, 2]])
        inv, valid = mat3.inverse(a)
        assert bool(valid)
        assert_near(mat3.mul(a, inv), np.eye(3), tol=1e-5)
        assert_twin(inv, lambda x: jmat3.inverse(x)[0], a)

    def test_inverse_singular(self):
        singular = m([[1, 2, 3], [2, 4, 6], [1, 1, 1]])
        inv, valid = mat3.inverse(singular)
        assert not bool(valid)
        assert_near(inv, np.eye(3))  # the default
        inv, _ = mat3.inverse(singular, default=torch.zeros(3, 3))
        assert_near(inv, np.zeros((3, 3)))

    def test_mul_vec3_corrected(self):
        # the reference's mul_vec3 is a stub (mat3.rs:52-54 returns rhs);
        # both packages compute the real product
        a = m([[0, -1, 0], [1, 0, 0], [0, 0, 1]])
        assert_near(mat3.mul_vec3(a, vec(1, 0, 0)), vec(0, 1, 0))
        assert_twin(mat3.mul_vec3(a, vec(1, 2, 3)), jmat3.mul_vec3, a,
                    vec(1, 2, 3))

    def test_batched_inverse(self):
        rng = np.random.default_rng(0)
        a = rng.normal(size=(10, 3, 3)).astype(np.float32) + 3.0 * np.eye(
            3, dtype=np.float32)                       # well-conditioned
        inv, valid = mat3.inverse(torch.from_numpy(a))
        assert bool(valid.all())
        assert_near(torch.matmul(torch.from_numpy(a), inv),
                    np.broadcast_to(np.eye(3), (10, 3, 3)), tol=1e-4)
        assert_twin(inv, lambda x: jmat3.inverse(x)[0], a)
        assert_twin(mat3.det(torch.from_numpy(a)), jmat3.det, a)


def test_project():
    # maths.rs:259-269
    assert_near(maths.project(vec(1, 1, 0), vec(1, 0, 0)), vec(1, 0, 0))
    assert_near(maths.project(vec(2, 3, 0), vec(2, 1, 0)), vec(2.8, 1.4, 0))
    rng = np.random.default_rng(1)
    v, onto = (rng.normal(size=(16, 3)).astype(np.float32) for _ in "ab")
    assert_twin(maths.project(torch.from_numpy(v), torch.from_numpy(onto)),
                jmaths.project, v, onto)


class TestColor:
    def test_color_and_quirky_lerp(self):
        a, b = color.color(1.0, 0.5, 0.2), color.color(0.3, 0.3, 0.3)
        assert a.dtype == torch.float32 and a.shape == (3,)
        got = color.lerp_with_alpha(a, b, 0.3)
        # color.rs:39-47 multiplies the two scaled colours
        assert_near(got, (np.array([1.0, 0.5, 0.2]) * 0.7)
                    * (np.array([0.3, 0.3, 0.3]) * 0.3))
        want = jcolor.lerp_with_alpha(jcolor.color(1.0, 0.5, 0.2),
                                      jcolor.color(0.3, 0.3, 0.3), 0.3)
        assert np.array_equal(got.numpy(), np.asarray(want))

    def test_u8_round_trip(self):
        rng = np.random.default_rng(2)
        x = rng.uniform(-0.5, 1.5, (64, 3)).astype(np.float32)
        u8 = color.to_u8(torch.from_numpy(x))
        assert u8.dtype == torch.uint8
        assert np.array_equal(u8.numpy(), np.asarray(jcolor.to_u8(x)))
        back = color.from_u8(u8)
        assert_twin(back, jcolor.from_u8, u8.numpy())
        inside = (x >= 0.0) & (x <= 1.0)
        assert np.all(np.abs(back.numpy() - x)[inside] < 0.01)


def test_closest_hit_batch_argmin_equals_closest_hit_batch():
    # no exact ties on the FFI world's spheres and triangles: the two
    # formulations agree, and the argmin one agrees with JAX's
    tw, jw = rtt.models.ffi_example_world(), rt.models.ffi_example_world()
    scene, jscene = tw.to_scene(), jw.to_scene()
    rng = np.random.default_rng(4)
    o = np.zeros((256, 3), np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pack = intersect.pack_scene(scene)
    for sign in (True, False):
        got = intersect.closest_hit_batch_argmin(
            torch.from_numpy(o), torch.from_numpy(d), scene, pack,
            parity_plane_sign=sign)
        ref = intersect.closest_hit_batch(
            torch.from_numpy(o), torch.from_numpy(d), scene, pack,
            parity_plane_sign=sign)
        assert bool(got.hit.any()) and bool((~got.hit).any())
        assert torch.equal(got.hit, ref.hit) and torch.equal(got.mat, ref.mat)
        h = got.hit
        assert_near(got.t[h], ref.t[h], tol=1e-6)
        assert_near(got.normal[h], ref.normal[h], tol=1e-5)
        want = jintersect.closest_hit_batch_argmin(
            jnp.asarray(o), jnp.asarray(d), jscene,
            jintersect.pack_scene(jscene), parity_plane_sign=sign)
        assert np.array_equal(got.hit.numpy(), np.asarray(want.hit))
        assert np.array_equal(got.mat.numpy(), np.asarray(want.mat))
        np.testing.assert_allclose(got.t.numpy()[h], np.asarray(want.t)[h],
                                   rtol=1e-5)


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert log_dir == str(tmp_path / "tr")
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())
