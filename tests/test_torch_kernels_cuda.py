"""The CUDA kernels against their plain PyTorch versions on the card.

Needs a CUDA device and nvcc (skips otherwise).  On a machine with a card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

The checks and their tolerances are chip_smoke.py's, at a smaller size.
"""

import dataclasses

import pytest
import torch

import claymore_tpu_torch as ct
from claymore_tpu_torch.io.sampler import sample_uniform_box_world
from claymore_tpu_torch.scripts.prof_k1 import permute_tiles, stir
from claymore_tpu_torch.scripts.bench import sdf_dome

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke

    return chip_smoke


def test_grid_kernel_matches_plain(card):
    cfg = ct.SimConfig(domain_bits=7, max_active_blocks=5000)   # ragged: 5001 rows
    card.check_grid_kernel(cfg, n_active=cfg.num_oct_keys, time_it=False)


def test_grid_colliders_kernel_matches_plain(card):
    cfg = ct.SimConfig(domain_bits=7, max_active_blocks=5000)
    card.check_grid_colliders_kernel(cfg, n_active=cfg.num_oct_keys, t=0.37,
                                     time_it=False)


def test_grid_sdf_kernel_matches_plain(card):
    cfg = ct.SimConfig(domain_bits=7, max_active_blocks=5000)
    card.check_grid_sdf_kernel(cfg, n_active=cfg.num_oct_keys, t=0.37, time_it=False)


@pytest.mark.parametrize("kernel", ["colliders", "sdf"])
def test_grid_collider_kernels_straddle_pool(card, kernel):
    """Every row crosses one collider's surface, so that collider is never
    culled on it (check_collider_kernel's ``crossed``); the kernel matches
    the plain version and its cull equals collider_row_mask."""
    cfg = ct.SimConfig(domain_bits=7, max_active_blocks=5000)
    check = (card.check_grid_colliders_kernel if kernel == "colliders"
             else card.check_grid_sdf_kernel)
    r = check(cfg, 0, t=0.37, time_it=False, straddle=True)
    assert r["culled_share"] < 1.0


def _many_colliders(n, sdf):
    """``n`` colliders in the unit box from a seed: moving, rotating and
    scaled spheres, boxes and half-spaces of every kind, the dome first
    when ``sdf``."""
    import numpy as np

    from claymore_tpu_torch.models.boundary import Box, HalfSpace, RigidMotion, Sphere

    rng = np.random.default_rng(n)
    cols = [sdf_dome()] if sdf else []
    kinds = ("sticky", "slip", "separate")
    while len(cols) < n:
        i = len(cols)
        c = tuple(float(v) for v in rng.uniform(0.2, 0.8, 3))
        motion = RigidMotion(trans_vel=tuple(float(v) for v in rng.normal(0, 0.05, 3)),
                             omega=(0.0, float(rng.normal(0, 1.0)), 0.0),
                             scale=1.0, dsdt=float(rng.uniform(-0.2, 0.2)))
        kw = dict(kind=kinds[i % 3], friction=float(rng.uniform(0, 0.3)), motion=motion)
        if i % 3 == 0:
            cols.append(Sphere(c, float(rng.uniform(0.03, 0.1)), **kw))
        elif i % 3 == 1:
            h = rng.uniform(0.02, 0.08, 3)
            cols.append(Box(tuple(float(v) for v in c - h), tuple(float(v) for v in c + h),
                            **kw))
        else:
            cols.append(HalfSpace((0.0, float(rng.uniform(0.02, 0.1)), 0.0),
                                  tuple(float(v) for v in rng.normal(0, 0.1, 3) + (0, 1, 0)),
                                  **kw))
    return tuple(cols)


@pytest.mark.parametrize("sdf", [False, True])
@pytest.mark.parametrize("n", [17, 40])
def test_grid_collider_kernels_take_long_lists(card, n, sdf):
    """Lists past 16 and 32 colliders (the shared memory grows with the
    list): the kernel matches the plain version and its cull the twin."""
    cfg = ct.SimConfig(domain_bits=7, max_active_blocks=5000)
    part, pool, _ = card.collider_pool(cfg, cfg.num_oct_keys, (), False)
    card.check_collider_kernel(cfg, part, pool, _many_colliders(n, sdf), 0.37,
                               f"{n} colliders", time_it=False)


def test_engine_refuses_more_colliders_than_the_kernel_takes(card):
    from claymore_tpu_torch.models.boundary import Sphere
    from claymore_tpu_torch.ops import grid_kernel

    cfg = ct.SimConfig(domain_bits=7, max_active_blocks=256)
    mat = ct.JFluid(volume=cfg.default_volume())
    n = grid_kernel.max_colliders()
    assert n >= 40
    cols = [Sphere((0.5, 0.5, 0.5), 0.1)] * (n + 1)
    with pytest.raises(ValueError, match="at most"):
        ct.MPMEngine(cfg, [mat], colliders=cols, device="cuda")
    ct.MPMEngine(cfg, [mat], colliders=cols[:n], device="cuda")


@pytest.mark.parametrize("t", [0.0, 2.0])
@pytest.mark.parametrize("kernel", ["colliders", "sdf"])
def test_grid_collider_kernels_cull_at_other_times(card, kernel, t):
    """The kernel's per-(row, collider) cull equals collider_row_mask, and
    the output the plain version's, with the colliders posed elsewhere."""
    cfg = ct.SimConfig(domain_bits=7, max_active_blocks=5000)
    check = (card.check_grid_colliders_kernel if kernel == "colliders"
             else card.check_grid_sdf_kernel)
    r = check(cfg, n_active=cfg.num_oct_keys, t=t, time_it=False)
    assert 0.0 < r["culled_share"] < 1.0


def test_sdf_engine_launches_the_sdf_kernel(card):
    """An engine with an SDF collider on the card runs K2-SDF each substep
    and keeps mass and particles."""
    from claymore_tpu_torch.ops import grid_kernel

    cfg = ct.SimConfig(domain_bits=7, max_active_blocks=2048, default_dt=2e-4,
                       particle_tile=512)
    pos = sample_uniform_box_world(cfg.dx, [0.45, 0.1, 0.25], [0.65, 0.3, 0.45], cfg.ppc)
    cfg = dataclasses.replace(cfg, max_tiles=ct.exact_tiles(cfg, [pos], slack=1.5))
    mat = ct.JFluid(volume=cfg.default_volume())
    eng = ct.MPMEngine(cfg, [mat], colliders=(sdf_dome(),), tile_chunk=8,
                       device="cuda")
    state = eng.init_state([pos], [(1.0, 0.0, 0.0)])
    before = grid_kernel.grid_update.launches["grid_update_sdf"]
    state = eng.run_steps(state, 20, 1.0)
    assert grid_kernel.grid_update.launches["grid_update_sdf"] - before == 20
    d = eng.diagnostics(state)
    assert abs(d["grid_mass"] - pos.shape[0] * mat.mass) < 1e-5 * pos.shape[0] * mat.mass
    assert d["model0_active"] == pos.shape[0] and d["null_block_mass"] == 0.0
    assert card.sdf_contact(cfg, state, eng.colliders) > 0


def _material(name, vol):
    return {"fixed_corotated": lambda: ct.FixedCorotated(volume=vol, e=5e3, nu=0.4),
            "jfluid": lambda: ct.JFluid(volume=vol),
            "sand": lambda: ct.Sand(volume=vol, e=1e4, rho=1500.0),
            "nacc": lambda: ct.NACC(volume=vol, e=1e4)}[name]()


@pytest.mark.parametrize("name", ["fixed_corotated", "jfluid", "sand", "nacc"])
def test_g2p2g_kernel_matches_plain(card, name):
    cfg = ct.SimConfig(domain_bits=7, max_active_blocks=2048, default_dt=2e-4,
                       particle_tile=512)
    pos = sample_uniform_box_world(cfg.dx, [0.3, 0.45, 0.35], [0.55, 0.6, 0.5], cfg.ppc)
    cfg = dataclasses.replace(cfg, max_tiles=ct.exact_tiles(cfg, [pos], slack=1.25))
    mat = _material(name, cfg.default_volume())
    eng = ct.MPMEngine(cfg, [mat], tile_chunk=8, device="cuda")
    state = eng.init_state([pos], [(0.3, -0.5, 0.2)])
    card.check_g2p2g_kernel(cfg, mat, state, tile_chunk=8, time_it=False)
    # a sheared, compressed velocity field takes the return maps' branches
    card.check_g2p2g_kernel(cfg, mat, stir(state), tile_chunk=8, time_it=False)


@pytest.mark.parametrize("order", ["permuted", "sorted"])
def test_g2p2g_kernel_slot_orders_match_plain(card, order):
    """K1 on a copy of a state whose tiles' slots are permuted, or sorted by
    stencil base, agrees with the plain version on that copy."""
    cfg = ct.SimConfig(domain_bits=7, max_active_blocks=2048, default_dt=2e-4,
                       particle_tile=512)
    pos = sample_uniform_box_world(cfg.dx, [0.3, 0.45, 0.35], [0.55, 0.6, 0.5], cfg.ppc)
    cfg = dataclasses.replace(cfg, max_tiles=ct.exact_tiles(cfg, [pos], slack=1.25))
    mat = _material("fixed_corotated", cfg.default_volume())
    eng = ct.MPMEngine(cfg, [mat], tile_chunk=8, device="cuda")
    state = stir(eng.init_state([pos], [(0.3, -0.5, 0.2)]))
    card.check_g2p2g_kernel(cfg, mat, permute_tiles(cfg, state, order), tile_chunk=8,
                            time_it=False)


@pytest.mark.parametrize("name", ["jfluid", "sand"])
def test_g2p2g_kernel_margin_is_arena_margin(card, name):
    """The drift margin K1 returns equals arena_margin of its output bit for
    bit, on an engine's state after a few substeps (a multi-tile scene)."""
    cfg = ct.SimConfig(domain_bits=7, max_active_blocks=2048, default_dt=2e-4,
                       particle_tile=256, rebucket_auto=True)
    pos = sample_uniform_box_world(cfg.dx, [0.2, 0.3, 0.35], [0.5, 0.55, 0.5], cfg.ppc)
    cfg = dataclasses.replace(cfg, max_tiles=ct.exact_tiles(cfg, [pos], slack=1.5))
    eng = ct.MPMEngine(cfg, [_material(name, cfg.default_volume())], tile_chunk=8,
                       device="cuda")
    state = eng.run_steps(eng.init_state([pos], [(1.5, -1.0, 0.5)]), 10, 1.0)
    margins = card.check_fused_margin(eng, state)
    assert 0.0 < margins[0] < 6.0


def _span4_engine(name, tile=512, every=4, v0=(1.5, -1.0, 0.5), **kw):
    """A span-4 engine (``rebucket_every=every``, 3..8) on the card and its
    initial state: the box of the K1 checks above."""
    cfg = ct.SimConfig(domain_bits=7, max_active_blocks=2048, default_dt=2e-4,
                       particle_tile=tile, rebucket_every=every, **kw)
    pos = sample_uniform_box_world(cfg.dx, [0.3, 0.45, 0.35], [0.55, 0.6, 0.5], cfg.ppc)
    cfg = dataclasses.replace(cfg, max_tiles=ct.exact_tiles(cfg, [pos], slack=1.5))
    eng = ct.MPMEngine(cfg, [_material(name, cfg.default_volume())], tile_chunk=8,
                       device="cuda")
    return eng, eng.init_state([pos], [v0]), pos


@pytest.mark.parametrize("name", ["fixed_corotated", "jfluid", "sand", "nacc"])
def test_g2p2g_span4_kernel_matches_plain(card, name):
    """K1's span-4 variant (16-cell arenas from one block below the home
    block, G2P from pool_v) against the plain version, as the span-2 test
    above, its margin bit for bit; also on the state after a span-4
    engine's first rebuild, whose particles have drifted."""
    eng, state, _ = _span4_engine(name)
    cfg, mat = eng.cfg, eng.materials[0]
    card.check_g2p2g_kernel(cfg, mat, state, tile_chunk=8, time_it=False)
    card.check_g2p2g_kernel(cfg, mat, stir(state), tile_chunk=8, time_it=False)
    state = eng.run_steps(state, 6, 1.0)
    assert eng.rebuilds == 1
    card.check_g2p2g_kernel(cfg, mat, stir(state), tile_chunk=8, time_it=False)


def test_g2p2g_span4_engine_runs_on_the_kernel(card):
    """A span-4 engine with the incremental rebucket on the card: every
    substep launches the span-4 variant, mass and particles are kept, the
    fused margin equals arena_margin and lies in (0, 14)."""
    from claymore_tpu_torch.ops import g2p2g_kernel

    eng, state, pos = _span4_engine("jfluid", defrag_every=2)
    mat = eng.materials[0]
    before = dict(g2p2g_kernel.g2p2g.launches)
    state = eng.run_steps(state, 17, 1.0)
    after = g2p2g_kernel.g2p2g.launches
    assert after["g2p2g_jfluid_span4"] - before["g2p2g_jfluid_span4"] == 17
    assert after["g2p2g_jfluid"] == before["g2p2g_jfluid"]
    assert eng.rebuilds == 4
    d = eng.diagnostics(state)
    assert abs(d["grid_mass"] - pos.shape[0] * mat.mass) < 1e-5 * pos.shape[0] * mat.mass
    assert d["model0_active"] == pos.shape[0] and d["null_block_mass"] == 0.0
    assert d["model0_dropped_tiles"] == 0 and d["block_overflow"] == 0
    margins = card.check_fused_margin(eng, state)
    assert 0.0 < margins[0] < 14.0


@pytest.mark.parametrize("span", [2, 4])
@pytest.mark.parametrize("name", ["fixed_corotated", "jfluid"])
def test_g2p2g_kernel_tile_range_matches_plain(card, name, span):
    """K1 on [0, bt) then [bt, T) into one output (the multi-device
    transfer split) against the plain version on the same ranges, at both
    arena spans; its margin, the minimum of the two, is arena_margin of the
    output bit for bit."""
    if span == 4:
        eng, state, _ = _span4_engine(name)
    else:
        eng, state, _ = _span4_engine(name, every=1)
    cfg, mat = eng.cfg, eng.materials[0]
    nt = state.models[0].tiles.tvalid.shape[0]
    for bt in (8, 8 * (nt // 16), nt - 8):
        card.check_g2p2g_kernel(cfg, mat, stir(state), tile_chunk=8, time_it=False,
                                tile_split=bt)


def _multi(mesh, device, overlap=True, **kw):
    cfg = ct.SimConfig(domain_bits=6, max_active_blocks=1024, default_dt=5e-4,
                       particle_tile=256, **kw)
    mat = ct.FixedCorotated(volume=cfg.default_volume(), e=5e3, nu=0.4)
    pos = sample_uniform_box_world(cfg.dx, [0.3, 0.4, 0.3], [0.7, 0.6, 0.7], cfg.ppc)
    eng = ct.MultiChipEngine(cfg, [mat], mesh_shape=mesh, tile_chunk=8, device=device,
                             migration_capacity=65536, overlap_halo=overlap)
    return eng, eng.init_state([pos], [(6.0, -0.5, 4.0)]), pos


@pytest.mark.parametrize("mesh", [(2, 2), (4,)])
def test_multi_engine_on_the_card_matches_the_cpu(card, mesh):
    """Every shard on the card, overlap on and off: the kernels run (K2 once
    per shard and substep), nothing is lost, and positions by pid and the
    owner-counted mass agree with the same mesh on the CPU within 1e-5."""
    from claymore_tpu_torch.ops import g2p2g_kernel, grid_kernel

    steps = 12
    runs = {}
    for device, overlap in (("cuda", True), ("cuda", False), ("cpu", True)):
        eng, st, pos = _multi(mesh, device, overlap, rebucket_auto=True)
        before = (grid_kernel.grid_update.launches["grid_update"],
                  g2p2g_kernel.g2p2g.launches["g2p2g_fixed_corotated"])
        st = eng.run_steps(st, steps, 1.0)
        d = eng.diagnostics(st)
        assert d["model0_active"] == pos.shape[0]
        assert d["migration_dropped"] == d["halo_overflow"] == d["block_overflow"] == 0
        if device == "cuda":
            assert grid_kernel.grid_update.launches["grid_update"] - before[0] == \
                steps * eng.n_dev
            assert g2p2g_kernel.g2p2g.launches["g2p2g_fixed_corotated"] - before[1] >= \
                steps * eng.n_dev
        n = pos.shape[0]
        out = torch.full((3, n), float("nan"))
        for x in st:
            m = x.models[0]
            out[:, m.pid[m.active].long().cpu()] = m.pos[:, m.active].cpu()
        runs[(device, overlap)] = (out, d["grid_mass"], eng.rebuilds)
    ref, mass, _ = runs[("cpu", True)]
    for key, (out, m, rebuilds) in runs.items():
        assert float((out - ref).abs().max()) < 1e-5, key
        assert abs(m - mass) < 1e-5 * mass, key
        assert rebuilds > 0


@pytest.mark.parametrize("raster_tiles", [24, 2048])
def test_init_on_the_card_rasterizes_like_the_cpu(card, monkeypatch, raster_tiles):
    """``rasterize_model`` on a card takes chunks of RASTER_TILES tiles with
    a short last one (24 does not divide the tile count, 2048 holds every
    tile): the initial pool equals the CPU's, which takes the engine's
    chunks, within f32 roundoff of its sums, and the particles are equal."""
    from claymore_tpu_torch.core import transfer

    monkeypatch.setattr(transfer, "RASTER_TILES", raster_tiles)
    cfg = ct.SimConfig(domain_bits=6, max_active_blocks=1024, particle_tile=256)
    mat = ct.FixedCorotated(volume=cfg.default_volume())
    pos = sample_uniform_box_world(cfg.dx, [0.3, 0.4, 0.3], [0.7, 0.6, 0.7], cfg.ppc)
    states = [ct.MPMEngine(cfg, [mat], tile_chunk=8, device=d).init_state(
        [pos], [(1.0, -0.5, 0.25)]) for d in ("cuda", "cpu")]
    nt = states[1].models[0].tiles.tvalid.shape[0]
    assert nt % raster_tiles or raster_tiles > nt
    a, b = (s.grid.cpu() for s in states)
    assert torch.equal(states[0].partition.table.cpu(), states[1].partition.table)
    assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    assert torch.equal(states[0].models[0].pos.cpu(), states[1].models[0].pos)


def test_g2p2g_span4_refuses_a_tile_it_cannot_take(card):
    """At span 4 FixedCorotated's layout at tile 1024 does not fit a block's
    shared memory: the wrapper raises, and kernel_info says 0 blocks."""
    from claymore_tpu_torch.ops import g2p2g_kernel

    mat = ct.FixedCorotated(volume=1e-6)
    assert g2p2g_kernel.kernel_info(mat, 1024, 4)["blocks_per_sm"] == 0
    assert g2p2g_kernel.kernel_info(mat, 512, 4)["blocks_per_sm"] >= 1
    eng, state, _ = _span4_engine("fixed_corotated", tile=1024)
    with pytest.raises(NotImplementedError):
        eng.substep(state, 1.0)


def test_incremental_plan_on_the_card_equals_the_cpu(card):
    """incremental_plan on a CUDA state with movers equals the same call on
    its CPU copy bit for bit, at the default mover buffer and at one so
    small that movers are deferred."""
    eng, state, _ = _span4_engine("jfluid", every=8, v0=(4.0, -3.0, 2.0))
    state = eng.run_steps(state, 7, 1.0)      # 0.72 cells of drift in x, no rebuild
    assert eng.rebuilds == 0
    cfg = eng.cfg
    r = card.check_incremental_plan(cfg, state.models[0])
    assert r["movers"] > 0
    tight = dataclasses.replace(cfg, mover_capacity_frac=0.001)
    r = card.check_incremental_plan(tight, state.models[0])
    assert r["deferred"] > 0


@pytest.mark.parametrize("name", ["dyn_roll", "dyn_lane_read", "dyn_lane_read_wide",
                                  "dyn_lane_write"])
def test_lane_probe_kernel_matches_plain(card, name):
    card.check_laneops(tiles=1000, time_it=False, names=(name,))


def test_dma_probe_kernels_match_plain(card):
    card.check_dma(time_it=False, rows=4096,
                   p5={False: [(256, 4, 9), (300, 8, 1)], True: [(256, 4, 9), (200, 16, 1)]},
                   p6=[(64, 4, 9), (100, 4, 3)])


def test_dma_probe_kernels_match_plain_at_the_script_configs(card):
    """P5 (both variants, both plans) at every configuration of
    P5_CONFIGS and P6 at P6_CONFIGS, on the 0.5 GiB pool; P6 on the zero
    and the 2**24/0.1 pools."""
    r = card.check_dma(time_it=False)
    assert len(r["dma_gather"]) == len(r["dma_gather_ring"]) == 4 and len(r["rmw"]) == 2
    assert {e["plan"] for e in r["dma_gather"]} == {"direct", "two_pass"}


def _dma_inputs(o, starts, runs):
    import numpy as np

    pool = torch.arange(o * 2048, dtype=torch.float32, device="cuda").reshape(o, 16, 128)
    idx = torch.from_numpy(np.asarray(starts, np.int32)).cuda().view(-1, runs)
    return pool, idx


def _all_gathers(pk, pool, idx, r):
    plans = pk.PLANS if 2 <= r <= pk.MAX_WINDOW_ROWS else ("direct",)
    return {(ring, plan): pk._launch_gather(pool, idx, r, ring, plan)
            for ring in (False, True) for plan in plans}


@pytest.mark.parametrize("r", [1, 3, 9])
def test_dma_kernels_one_start_repeated(card, r):
    """One start named G D times, the most overlap: every P5 variant and
    plan equals the plain version, and P6 adds 1.0 G times (once per
    program) on the 2**24/0.1 pool, as its plain version."""
    from claymore_tpu_torch.ops import probe_kernels as pk

    o, g, d = 4096, 512, 4
    pool, idx = _dma_inputs(o, [1000] * (g * d), d)
    want = pk.plain_dma_gather(pool, idx, r)
    for key, got in _all_gathers(pk, pool, idx, r).items():
        assert torch.equal(got, want), key
    kp, pp = card.p6_pool(o, zero=False), card.p6_pool(o, zero=False)
    ko, po = pk.rmw(kp, idx, r), pk.plain_rmw(pp, idx, r)
    assert torch.equal(kp, pp) and torch.equal(ko, po)
    zp = card.p6_pool(o)
    pk.rmw(zp, idx, r)
    assert float(zp.max()) == g and int((zp.view(o, -1)[:, 0] > 0).sum()) == r


def test_dma_kernels_out_of_range_starts(card):
    """A start outside [0, O - R]: P5 writes NaN for its program and the
    other programs' sums are right, in every variant and plan; P6 writes NaN
    to out[g, 0], the run adds nothing and the program's other runs still
    count; starts that all lie outside leave the pool untouched."""
    import numpy as np

    from claymore_tpu_torch.ops import probe_kernels as pk

    o, g, d, r = 4096, 64, 4, 9
    rng = np.random.default_rng(3)
    starts = rng.integers(0, o - r + 1, size=(g, d))
    bad = starts.copy()
    bad[5, 2], bad[9, 0], bad[17, 3] = -1, o - r + 1, 10 ** 6
    pool, idx = _dma_inputs(o, bad.reshape(-1), d)
    _, good = _dma_inputs(o, starts.reshape(-1), d)
    want = pk.plain_dma_gather(pool, good, r)
    rows_bad = torch.tensor([5, 9, 17], device="cuda")
    keep = torch.ones(g, dtype=torch.bool, device="cuda")
    keep[rows_bad] = False
    for key, got in _all_gathers(pk, pool, idx, r).items():
        assert bool(got[rows_bad].isnan().all()), key
        assert torch.equal(got[keep], want[keep]), key
    # under P6 a repeated start of one program adds nothing: the plain
    # version of the good runs has each bad start replaced by its
    # program's first start
    same = starts.copy()
    same[5, 2], same[9, 0], same[17, 3] = same[5, 0], same[9, 1], same[17, 0]
    _, alike = _dma_inputs(o, same.reshape(-1), d)
    kp, pp = card.p6_pool(o, zero=False), card.p6_pool(o, zero=False)
    ko, po = pk.rmw(kp, idx, r), pk.plain_rmw(pp, alike, r)
    assert torch.equal(kp, pp)
    assert bool(ko[rows_bad, 0].isnan().all()) and torch.equal(ko[keep], po[keep])
    none = card.p6_pool(o, zero=False)
    before = none.clone()
    _, outside = _dma_inputs(o, [-5, o - r + 1] * 8, 2)
    ko = pk.rmw(none, outside, r)
    assert torch.equal(none, before) and bool(ko[:, 0].isnan().all())


def test_dma_info_names_every_sub_kernel(card):
    from claymore_tpu_torch.ops import probe_kernels as pk

    for name, subs in pk.DMA_SUBKERNELS.items():
        info = pk.dma_info(name)
        assert set(info) == set(subs)
        for v in info.values():
            assert 0 < v["registers"] <= 255 and v["blocks_per_sm"] >= 1
