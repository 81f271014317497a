"""Single-ray crossing-trace diagnostic (the RECORD_INTERSECTED_POINTS
analog, DDATestCpp.cpp:15-25): the per-iteration dump of the traversal's
event loop must agree with the GPU kernel's results AND, event by event,
with the scalar oracle's crossing log."""

import jax.numpy as jnp
import numpy as np

from voxelengine_tpu.oracle import reference as R
from voxelengine_tpu.ops.crossing_trace import format_crossings, trace_ray_crossings
from voxelengine_tpu.ops.trace_kernel import trace_brickmap_kernel

F32 = np.float32


def test_crossing_dump_matches_kernel_results(small_world, ray_batch):
    """Final hit/position/normal/steps of the dump == the GPU kernel's (in
    interpret mode), for a mixed batch (hits, misses, inside starts) — the
    dump really is the traversal's event sequence, not a third
    semantics."""
    dense, _, bm = small_world
    origins, rays = ray_batch
    idx = list(range(0, 40, 5))  # 8 mixed rays
    out = trace_brickmap_kernel(
        bm, jnp.asarray(origins[idx]), jnp.asarray(rays[idx]),
        max_steps=256, interpret=True,
    )
    for j, i in enumerate(idx):
        dump = trace_ray_crossings(bm, origins[i], rays[i], max_steps=256)
        assert dump["hit"] == bool(out.hit[j]), (i, format_crossings(dump))
        assert dump["steps_total"] == int(out.steps[j]), i
        if dump["hit"]:
            assert np.allclose(dump["position"], np.asarray(out.position[j]),
                               atol=1e-5), i
            assert np.array_equal(dump["normal"], np.asarray(out.normal[j])), i


def _oracle_fine_visits(rec):
    """Group the oracle record's fine crossings into chunk visits (split on
    chunk change or an intervening coarse record)."""
    visits, cur, cur_chunk = [], None, None
    for e in rec:
        if e[0] == "coarse":
            cur = None
            continue
        _, cell, point, chunk = e
        if cur is None or chunk != cur_chunk:
            cur, cur_chunk = [], chunk
            visits.append((chunk, cur))
        cur.append((tuple(int(v) for v in cell), point))
    return visits


def _dump_fine_visits(dump):
    """Group the dump's fstep events into chunk visits (one per descend)."""
    visits, cur = [], None
    for k in range(dump["iterations"]):
        ph = dump["phase"][k]
        if "desc" in ph:
            cur = []
            visits.append((tuple(int(v) for v in dump["coarse_cell"][k]), cur))
        elif "fstep" in ph and cur is not None:
            cur.append((tuple(dump["fine_cell"][k]), dump["point"][k]))
    return visits


def test_crossing_dump_matches_oracle_events(small_world, ray_batch):
    """Event-level parity: the dump's entered-cell sequences (one DDA
    event per iteration) equal the oracle's record= crossing log:
    coarse cells exactly; fine crossings per chunk visit up to two
    documented fine-SEED classes that only add/remove LEADING crossings of
    a visit (they walk cells the chunk's tight occupancy box proves empty):
    (a) exact-face entries, where FP luck picks the padded edge cell
    (int(8.0)=8) vs the first interior cell (int(7.9999995)=7); (b) after
    a chunk exit, the oracle restarts at the chunk border while the
    production path seeds at the tight-AABB box entry.  The common suffix
    of each visit must match cell-exactly with positions to tolerance."""
    dense, _, bm = small_world
    origins, rays = ray_batch
    coarse, cdims, brick, cbounds = R.make_brickmap_callbacks(dense, 8)

    checked_hits = 0
    for i in range(0, 60, 5):
        rec = []
        res = R.raytrace_brickmap(
            coarse, cdims, brick, cbounds, 8, origins[i], rays[i],
            max_steps=256, record=rec,
        )
        if res.guard_tripped:
            continue  # the one documented deviation; measured separately
        dump = trace_ray_crossings(bm, origins[i], rays[i], max_steps=256)
        assert dump["hit"] == res.hit, (i, format_crossings(dump))

        # coarse alignment: every dumped cadv-entered cell must match the
        # oracle's next coarse crossing; an ascend-entered cell is optional
        # (the oracle restarts INSIDE the exited chunk, so it re-records
        # the exit crossing only when that chunk no longer AABB-hits —
        # e.g. leaving the world)
        oc = [tuple(int(v) for v in e[1]) for e in rec if e[0] == "coarse"]
        oi = 0
        for k in range(dump["iterations"]):
            ph = dump["phase"][k]
            if "cadv" in ph or "asc" in ph:
                cell = tuple(dump["coarse_cell"][k])
                if oi < len(oc) and oc[oi] == cell:
                    oi += 1
                else:
                    assert "asc" in ph, (i, cell, format_crossings(dump))
        assert oi == len(oc), (i, format_crossings(dump))

        ov = [(tuple(int(v) for v in c), ev) for c, ev in _oracle_fine_visits(rec)]
        kv = _dump_fine_visits(dump)
        # two-pointer alignment: every oracle visit pairs with a dumped
        # descend into the same chunk (coarse walks already asserted
        # equal); a dumped descend whose fine walk logs no crossing on
        # either side is skipped
        oi = 0
        for k_chunk, k_ev in kv:
            if oi < len(ov) and ov[oi][0] == k_chunk:
                o_ev = ov[oi][1]
                oi += 1
            else:
                o_ev = []
                assert not k_ev, (i, k_chunk, format_crossings(dump))
            common = min(len(k_ev), len(o_ev))
            for (ck, pk), (co, po) in zip(k_ev[-common:] if common else [],
                                          o_ev[-common:] if common else []):
                assert ck == co, (i, k_ev, o_ev)
                assert np.allclose(pk, po, atol=2e-3), i
        assert oi == len(ov), (i, format_crossings(dump))
        if res.hit:
            checked_hits += 1
            assert np.allclose(dump["position"], res.position, atol=2e-3), i
    assert checked_hits >= 5  # the corpus must actually exercise hits


def test_crossing_dump_events_account_for_steps(small_world, ray_batch):
    """Every charged step of the final record is one cadv, fstep or asc
    event of the dump; every fine step happens inside a descended chunk;
    a hit is the last event."""
    _, _, bm = small_world
    origins, rays = ray_batch
    hits = 0
    for i in range(0, 60, 3):
        dump = trace_ray_crossings(bm, origins[i], rays[i], max_steps=256)
        events = [e for ph in dump["phase"] for e in ph]
        charged = sum(e in ("cadv", "fstep", "asc") for e in events)
        assert charged == dump["steps_total"], (i, format_crossings(dump))
        inside = False
        for ph in dump["phase"]:
            if "desc" in ph:
                inside = True
            if "fstep" in ph:
                assert inside, (i, format_crossings(dump))
            if "asc" in ph:
                inside = False
        if dump["hit"] and not dump["hit_immediate"]:
            hits += 1
            assert "hit" in dump["phase"][-1], (i, format_crossings(dump))
    assert hits >= 3


def test_format_crossings_smoke(small_world, ray_batch):
    _, _, bm = small_world
    origins, rays = ray_batch
    s = format_crossings(
        trace_ray_crossings(bm, origins[0], rays[0], max_steps=256)
    )
    assert "iterations" in s and "hit=" in s
