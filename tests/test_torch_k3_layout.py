"""K3's walk on the card (``csrc/wavefront_binned.cu``, ``top_staged_walk``
in ``csrc/path_common.cuh``) modelled on the CPU, warp by warp.

The kernel votes a passing top's groups and sub-leaves once into a 32-bit
mask and then tests the masked sub-leaves in order, voting each one's group
again at its first masked sub-leaf and the sub-leaf itself again before its
test (the first one excepted: nothing has moved since the mask).  The
sequential walk votes each group and each sub-leaf just before it.  Both models below keep the kernel's run gates, early exit
on the run's entry key, node_exit reference point and dead-warp skip, and
test a sub-leaf's triangles with ``tri_block_hits`` in visit order (ties to
the last visited).  On ``mesh_scene(2)`` and a small OBJ frame, with
node_exit on and off, the staged model tests the same sub-leaves in the
same order as the sequential one in every warp of every pass, and each
model's frame is bitwise ``binned_pass_ref``'s, which grinds a passing top
whole: the same winners and ties.  Then the mask's premise: every top of
the three bench meshes' sorted tables spans at most 8 groups (32
sub-leaves), in the port's tables and the JAX package's alike, and the
wrapper's range check refuses a top that spans more."""

import numpy as np
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu.ops.pallas import wavefront_sorted as jso
import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import ops
from raytracer_tpu_torch.ops import tables
from raytracer_tpu_torch.ops.cuda import wavefront as wf
from raytracer_tpu_torch.ops.cuda import wavefront_binned as wb
from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws

WARP = wb.WARP
GROUP_SUBS = tables.GROUP_SUBS


def _box(a, ci, ray, inv, cull):
    """aabb_test of box ``ci`` of ``a`` (6, M) for each lane."""
    tn, tf = wb._aabb_entry(a[:, ci:ci + 1], ray, inv)
    return ((tn <= tf) & (tf > wf.T_MIN) & (tn <= cull[:, None]))[:, 0]


class WalkModel:
    """K3's culled walk, one warp at a time: ``staged`` votes a top's mask
    first (the kernel), else each group and sub-leaf just before it (the
    sequential walk).  ``log[(pass, warp)]`` lists the sub-leaves tested."""

    def __init__(self, staged):
        self.staged, self.log, self.pass_no = staged, {}, -1
        self.primary = self.node = False
        self.culled = 0     # masked sub-leaves a re-vote culled

    def binned_pass_ref(self, real):
        def run(T, cam_vec, state, **k):
            self.pass_no += 1
            self.primary = k["primary"]
            self.node = k["node_exit"] and not k["primary"]
            return real(T, cam_vec, state, **k)
        return run

    def top_hits(self, T, ray, h, alive, t_cap, row, pos, passes):
        rank = torch.full_like(alive, -1, dtype=torch.int64)
        for w in range(alive.shape[0] // WARP):
            lanes = torch.arange(w * WARP, (w + 1) * WARP)
            if bool(alive[lanes].any()):      # the dead-warp skip
                self.log[self.pass_no, w] = self._warp(
                    T, ray, h, alive, t_cap, int(row[lanes[0]]), lanes, rank)

    def _warp(self, T, ray, h, alive, t_cap, ref_i, lanes, rank):
        C = T.topr.shape[1]
        R8 = -(-C // tables.RUN)
        topr = T.topr.tolist()
        subn = T.subn[0].tolist()
        rw = [x[lanes] for x in ray]
        inv = [wf._inv_dir(d) for d in rw[3:]]
        live = alive[lanes]
        tested = []

        def cull():
            return torch.minimum(h[0][lanes], t_cap[lanes])

        def vote(a, ci):
            return bool((live & _box(a, ci, rw, inv, cull())).any())

        def test(li):
            n = subn[li]
            cols = torch.arange(li * tables.SUB, li * tables.SUB + n)
            if n:
                wf.tri_block_hits(T.tri, cols, ray, h, rank,
                                  len(tested) * tables.SUB, lanes)
            tested.append(li)

        if self.node:
            refp = T.refp
            d2 = (rw[0] - refp[0][ref_i]) * (rw[0] - refp[0][ref_i]) \
                + (rw[1] - refp[1][ref_i]) * (rw[1] - refp[1][ref_i]) \
                + (rw[2] - refp[2][ref_i]) * (rw[2] - refp[2][ref_i])
            dmax = torch.sqrt(torch.where(live, d2, 0.0).max())
            order = T.norder[ref_i].tolist()
        else:
            order = T.order[0].tolist()
        crunb, nrunb = T.crunb.tolist(), T.nrunb.tolist()
        for ri in range(R8):
            ki = min(ri * tables.RUN, C - 1)
            if self.primary:
                exit_key = T.keys[0][ki]
            elif self.node:
                exit_key = T.nkeys[ref_i][ki] - dmax
            else:
                exit_key = -1.0
            if not bool(cull().max() >= exit_key):
                break
            if self.primary or self.node:
                b, col = (crunb, ri) if self.primary else (nrunb,
                                                            ref_i * R8 + ri)
                if not bool((live & ws.bound_test(b, col, rw, cull()))
                            .any()):
                    continue
            for oi in range(ri * tables.RUN, min(ri * tables.RUN
                                                 + tables.RUN, C)):
                ci = order[oi]
                if not vote(T.topa, ci):
                    continue
                g0, g1 = topr[0][ci], topr[1][ci]
                if self.staged:
                    self.culled += self._staged_top(T, g0, g1, vote, test)
                    continue
                for g in range(g0, g1):
                    if not vote(T.grpa, g):
                        continue
                    for li in range(g * GROUP_SUBS, (g + 1) * GROUP_SUBS):
                        if vote(T.suba, li):
                            test(li)
        return tested

    @staticmethod
    def _staged_top(T, g0, g1, vote, test) -> int:
        mask = [li for g in range(g0, g1) if vote(T.grpa, g)
                for li in range(g * GROUP_SUBS, (g + 1) * GROUP_SUBS)
                if vote(T.suba, li)]
        assert len(mask) <= 32 and all(
            0 <= li - g0 * GROUP_SUBS < 32 for li in mask)
        parent, parent_pass, n_tested = None, True, 0
        for k, li in enumerate(mask):
            if parent is None:
                parent = li // GROUP_SUBS
            elif li // GROUP_SUBS != parent:
                parent = li // GROUP_SUBS
                parent_pass = vote(T.grpa, parent)
            if parent_pass and (k == 0 or vote(T.suba, li)):
                test(li)
                n_tested += 1
        return len(mask) - n_tested


FRAMES = {"mesh_scene2": (lambda: rtt.models.mesh_scene(2),
                          dict(width=32, height=16, samples_per_pixel=4,
                               depth=3, seed=5)),
          "obj_10k": (rtt.models.obj_mesh_scene,
                      dict(width=24, height=16, samples_per_pixel=4,
                           depth=3, seed=7))}


def _frame(name, node_exit):
    make, shape = FRAMES[name]
    scene, cam = make()
    (sph, scl, *t) = ops.scene_sorted_tables(scene, "cpu")
    order, keys = ops._camera_order(t[4], cam, "cpu")
    args = (sph, *t, tables.camera_vec(cam))
    return lambda: wb.render_linear_binned(
        *args, **shape, sph_clusters=scl, top_order=order, top_keys=keys,
        node_exit=node_exit, plain=True)


@pytest.mark.parametrize("node_exit", [True, False])
@pytest.mark.parametrize("name", sorted(FRAMES))
def test_staged_walk_tests_the_sequential_sub_leaves(name, node_exit,
                                                     monkeypatch):
    render = _frame(name, node_exit)
    want = render()
    logs = {}
    for staged in (False, True):
        model = WalkModel(staged)
        with monkeypatch.context() as m:
            m.setattr(wb, "binned_pass_ref",
                      model.binned_pass_ref(wb.binned_pass_ref))
            m.setattr(wb, "top_hits", model.top_hits)
            got = render()
        assert torch.equal(got[0], want[0]) and got[1] == want[1]
        logs[staged] = model.log
        # the re-votes matter: they cull masked sub-leaves (20 and 67 here)
        assert (model.culled > 0) == staged
    assert logs[True] == logs[False]
    assert sum(map(len, logs[True].values())) > 0


def _bench_meshes():
    from raytracer_tpu_torch.models.builders import icosphere_mesh
    from raytracer_tpu_torch.scene import (DIFFUSE, METAL, build_materials,
                                           build_scene)
    tris = (icosphere_mesh((-0.6, 0.0, -1.4), 0.45, 0, 6)
            + icosphere_mesh((0.6, 0.0, -1.2), 0.45, 2, 6))
    mats = build_materials([(DIFFUSE, (0.7, 0.3, 0.3), 0.0, 1.0),
                            (DIFFUSE, (0.8, 0.8, 0.0), 0.0, 1.0),
                            (METAL, (0.85, 0.85, 0.9), 0.05, 1.0)])
    big = build_scene([((0.0, -100.5, -1.0), 100.0, 1)], tris, mats,
                      exact_planes=True)
    from raytracer_tpu.models.builders import icosphere_mesh as jico
    from raytracer_tpu.scene import build_materials as jmats
    from raytracer_tpu.scene import build_scene as jscene
    jtris = (jico((-0.6, 0.0, -1.4), 0.45, 0, 6)
             + jico((0.6, 0.0, -1.2), 0.45, 2, 6))
    jbig = jscene([((0.0, -100.5, -1.0), 100.0, 1)], jtris,
                  jmats([(DIFFUSE, (0.7, 0.3, 0.3), 0.0, 1.0),
                         (DIFFUSE, (0.8, 0.8, 0.0), 0.0, 1.0),
                         (METAL, (0.85, 0.85, 0.9), 0.05, 1.0)]),
                  exact_planes=True)
    return {"mesh-1292": (rtt.models.mesh_scene(3)[0],
                          rt.models.mesh_scene(3)[0]),
            "OBJ-10k": (rtt.models.obj_mesh_scene()[0],
                        rt.models.obj_mesh_scene()[0]),
            "164k": (big, jbig)}


def test_every_bench_top_fits_the_32_bit_mask():
    for name, (scene, jscene_) in _bench_meshes().items():
        t = tables.build_tri_sorted_tables(scene)
        j = jso.build_tri_sorted_tables(jscene_)
        topr, subn = t[5], t[2]
        np.testing.assert_array_equal(topr, np.asarray(j[5]))
        np.testing.assert_array_equal(subn, np.asarray(j[2]))
        span = topr[1] - topr[0]
        assert span.min() >= 1 and span.max() <= tables.TOP_GROUPS, name
        assert span.max() * GROUP_SUBS <= 32
        assert topr[1].max() * GROUP_SUBS == subn.shape[1], name


def test_range_check_refuses_a_top_of_nine_groups():
    scene, cam = rtt.models.obj_mesh_scene()
    (sph, scl, *t) = ops.scene_sorted_tables(scene, "cpu")
    topr, grp = t[5].clone(), t[14]
    wb._check_index_ranges(sph, scl, t[2], topr, grp.shape[1],
                           torch.zeros((1, topr.shape[1]), dtype=torch.int32),
                           t[8])
    topr[1, 0] = topr[0, 0] + tables.TOP_GROUPS + 1
    with pytest.raises(ValueError, match="8 groups a top"):
        wb._check_index_ranges(sph, scl, t[2], topr, grp.shape[1],
                               torch.zeros((1, topr.shape[1]),
                                           dtype=torch.int32), t[8])
