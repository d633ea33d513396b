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
from claymore_tpu_torch.scripts.prof_k1 import carve_tiles, permute_tiles, spread_tiles, stir
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


@pytest.mark.parametrize("name", ["fixed_corotated", "jfluid", "sand", "nacc"])
def test_g2p2g_span4_wide_tiles_match_plain(card, name):
    """Tiles wider than the span-4 variant's P2G window (every 4th live
    tile's particles spread over its arena, ``spread_tiles``; the box above
    never leaves the window): the kernel transfers them in several passes,
    counts them (check_g2p2g_kernel holds the count equal to
    ``prof_k1.wide_tiles`` of its output) and matches the plain version, on
    the whole range and on the two ranges of the multi-device split."""
    eng, state, _ = _span4_engine(name)
    cfg, mat = eng.cfg, eng.materials[0]
    spread = spread_tiles(cfg, stir(state))
    r = card.check_g2p2g_kernel(cfg, mat, spread, tile_chunk=8, time_it=False)
    assert r["wide_tiles"] > 0
    nt = state.models[0].tiles.tvalid.shape[0]
    r = card.check_g2p2g_kernel(cfg, mat, spread, tile_chunk=8, time_it=False,
                                tile_split=8 * (nt // 16))
    assert r["wide_tiles"] > 0


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


@pytest.mark.parametrize("span", [2, 4])
@pytest.mark.parametrize("name", ["fixed_corotated", "jfluid", "sand", "nacc"])
def test_g2p2g_kernel_streams_occupied_prefixes(card, name, span):
    """K1 on a state with dead tiles (the capacity's slack), overflow tiles
    of 1-34 particles, tiles with holes and valid tiles with no active
    slot, every inactive slot NaN (``carve_tiles``): it matches the plain
    version, streams the sum of the input's occupied prefixes and leaves
    every slot past them inactive with pid S (``check_g2p2g_kernel``), on
    the whole range and on the two ranges of the multi-device split."""
    eng, state, _ = _span4_engine(name, every=4 if span == 4 else 1)
    cfg, mat = eng.cfg, eng.materials[0]
    assert cfg.arena_span == span
    carved = carve_tiles(cfg, stir(state))
    nt = state.models[0].tiles.tvalid.shape[0]
    assert int((~state.models[0].tiles.tvalid).sum()) > 0
    for split in (None, 8 * (nt // 16)):
        r = card.check_g2p2g_kernel(cfg, mat, carved, tile_chunk=8, time_it=False,
                                    tile_split=split)
        assert 0 < r["streamed_slots"] < r["slots"]


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
    """The span-4 layout (per-tile windows, span 2's shared memory) fits
    every tile the kernel takes: at 512 two blocks per SM (JFluid three),
    at 1024 one, and a span-4 engine at tile 1024 runs on the kernel.  What
    it refuses is a tile outside 32..1024: the wrapper raises."""
    from claymore_tpu_torch.ops import g2p2g_kernel

    for name, blocks in (("fixed_corotated", 2), ("jfluid", 3), ("sand", 2), ("nacc", 2)):
        mat = _material(name, 1e-6)
        assert g2p2g_kernel.kernel_info(mat, 512, 4)["blocks_per_sm"] >= blocks, name
        assert g2p2g_kernel.kernel_info(mat, 1024, 4)["blocks_per_sm"] >= 1, name
    eng, state, _ = _span4_engine("fixed_corotated", tile=1024)
    card.check_g2p2g_kernel(eng.cfg, eng.materials[0], state, tile_chunk=8, time_it=False)
    eng, state, _ = _span4_engine("fixed_corotated", tile=2048)
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


def _raw_model(case, name, tile=64):
    """A raw slot layout on the card for the rebucket checks: a sampled box
    of ``name``'s particles shuffled over the slots with holes (``scattered``),
    all in one block (``one_segment``), none active (``all_inactive``), or
    half the scattered slots (``tight``: the particles overflow them)."""
    import numpy as np

    from claymore_tpu_torch.core.types import ParticleModel

    cfg = ct.SimConfig(domain_bits=6, max_active_blocks=512, particle_tile=tile)
    mat = _material(name, cfg.default_volume())
    pts = sample_uniform_box_world(cfg.dx, [0.3, 0.35, 0.3], [0.55, 0.5, 0.6], cfg.ppc)
    if case == "one_segment":
        pts = pts[:300] * 0.0 + np.float32(6.5 * cfg.dx)    # home block (1, 1, 1)
    n_tiles = 3 * cfg.tiles_for(len(pts))      # room for every oct's group padding
    s_cap = n_tiles * tile
    rng = np.random.default_rng(7)
    slots = rng.permutation(s_cap)[:len(pts)]
    pos = rng.uniform(0.0, 1.0, size=(3, s_cap)).astype(np.float32)
    pos[:, slots] = pts.T
    active = np.zeros((s_cap,), bool)
    active[slots] = case != "all_inactive"
    dev = torch.device("cuda")
    fields = {k: torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32)).to(dev)
              for k, v in mat.init_fields(s_cap, dev).items()}
    pid = np.where(active, rng.permutation(s_cap), s_cap).astype(np.int32)
    model = ParticleModel(pos=torch.from_numpy(pos).to(dev), fields=fields,
                          active=torch.from_numpy(active).to(dev),
                          pid=torch.from_numpy(pid).to(dev), tiles=None)
    return cfg, model


@pytest.mark.parametrize("name", ["fixed_corotated", "jfluid", "sand", "nacc"])
@pytest.mark.parametrize("case", ["scattered", "one_segment", "all_inactive", "tight",
                                  "region", "region_no_interior", "region_no_boundary"])
def test_rebucket_kernels_match_plain(card, case, name):
    """The heads, plan and placement kernels equal their plain twins bit for
    bit (``chip_smoke.check_rebucket_kernel``), and the wrapper's
    sort_permute the plain version."""
    cfg, model = _raw_model("one_segment" if case == "one_segment" else
                            "all_inactive" if case == "all_inactive" else "scattered", name)
    if case == "tight":
        model = card.shuffle_slots(model, keep_slots=model.pos.shape[1] // 12 // 64 * 64)
    region = {"region": lambda k: (k % 3) == 0, "region_no_interior": lambda k: k >= 0,
              "region_no_boundary": lambda k: k < 0}.get(case)
    r = card.check_rebucket_kernel(cfg, model, f"{case} {name}", "test", region_fn=region,
                                   reps=1, plain_reps=1)
    assert r["max_abs_err"] == 0.0
    assert (r["dropped"] > 0) == (case == "tight")
    assert (r["segments"] == 0) == (case == "all_inactive")


def test_rebucket_keys_kernel_at_the_edges(card):
    """The keys kernel equals ``partition.home_keys`` on the card bit for bit
    where positions leave the grid, sit on cell-rounding boundaries or are
    not finite."""
    import numpy as np

    from claymore_tpu_torch.core import partition
    from claymore_tpu_torch.core.types import ParticleModel
    from claymore_tpu_torch.ops import rebucket_kernel

    cfg = ct.SimConfig(domain_bits=6, particle_tile=64)
    rng = np.random.default_rng(3)
    s_cap = 64 * 200
    pos = rng.uniform(-0.2, 1.2, size=(3, s_cap)).astype(np.float32)
    pos[:, :2000] = (rng.integers(-4, 70, size=(3, 2000)) + 0.5) / 64.0    # x / dx + 0.5 whole
    pos[0, 2000:2006] = [np.nan, np.inf, -np.inf, 3e38, -3e38, -0.0]
    active = rng.uniform(size=s_cap) < 0.9
    dev = torch.device("cuda")
    model = ParticleModel(pos=torch.from_numpy(pos).to(dev), fields={},
                          active=torch.from_numpy(active).to(dev),
                          pid=torch.zeros(s_cap, dtype=torch.int32, device=dev), tiles=None)
    got = rebucket_kernel.home_keys(cfg, model)
    assert torch.equal(got, partition.home_keys(cfg, model))
    assert int((got < cfg.grid_size ** 3).sum()) > 0


def test_engine_rebuilds_through_the_rebucket_kernels(card):
    """An engine on the card that rebuilds every substep launches each
    rebucket kernel once a rebuild (and once for the init's sort), and loses
    no particle."""
    from claymore_tpu_torch.ops import rebucket_kernel

    cfg = ct.SimConfig(domain_bits=6, max_active_blocks=512, default_dt=2e-4,
                       rebucket_auto=False, rebucket_every=1)
    mat = ct.FixedCorotated(volume=cfg.default_volume(), e=1e4, nu=0.3)
    pos = sample_uniform_box_world(cfg.dx, [0.4, 0.45, 0.4], [0.55, 0.6, 0.55], cfg.ppc)
    eng = ct.MPMEngine(cfg, [mat], tile_chunk=8, device="cuda")
    for k in rebucket_kernel.launches:
        rebucket_kernel.launches[k] = 0
    state = eng.run_steps(eng.init_state([pos], [(0.5, -1.0, 0.3)]), 3, 1.0)
    assert eng.rebuilds == 3
    assert set(rebucket_kernel.launches.values()) == {4}
    d = eng.diagnostics(state)
    assert d["model0_active"] == len(pos) and d["model0_dropped_tiles"] == 0


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


def _partition_inputs(case, seed=0):
    """One rebuild's inputs on the card, made from a numpy seed: an old
    partition of random octs, its pool rows random (some without mass in
    rows 0-3, one of -0.0, one holding a NaN, rows past the count dirty,
    the null row dirty for ``dirty_null``), tiles of random blocks in runs
    of one key with sentinels (the grid's corners and faces for ``faces``),
    a halo mask for ``extra``; span 4 for ``span4``, a capacity the octs
    overflow for ``overflow``."""
    import numpy as np

    from claymore_tpu_torch.core.types import Partition

    rng = np.random.default_rng(seed)
    nb = 24 if case == "overflow" else 2048
    cfg = ct.SimConfig(domain_bits=7, max_active_blocks=nb,
                       rebucket_every=4 if case == "span4" else 1)
    g, no = cfg.grid_size, cfg.num_oct_keys
    n3 = g ** 3
    count = 0 if case == "empty" else min(nb // 2, 300)
    old = np.sort(rng.choice(no, size=count, replace=False)).astype(np.int32)
    keys = np.full(nb, no, np.int32)
    keys[:count] = old
    keys[count:count + 3] = rng.choice(no, size=3)
    table = np.full(no + 1, cfg.null_oct, np.int32)
    table[old] = np.arange(count, dtype=np.int32)
    pool = rng.normal(size=(nb + 1, 16, 128)).astype(np.float32)
    pool[rng.uniform(size=nb + 1) < 0.3, 0:4] = 0.0
    if count >= 2:
        pool[0, 0:4] = -0.0
        pool[1, 0:4] = 0.0
        pool[1, 3, 5] = np.nan
    if case != "dirty_null":
        pool[nb] = 0.0
    tiles = []
    if case != "empty":
        blocks = rng.integers(0, n3, size=200 if case == "overflow" else 80)
        if case == "faces":
            blocks = np.array([(x * g + y) * g + z for x in (0, g // 2, g - 1)
                               for y in (0, g // 2, g - 1) for z in (0, 7, 8, g - 1)])
        runs = np.repeat(blocks, rng.integers(1, 4, size=blocks.shape[0]))
        runs[rng.uniform(size=runs.shape[0]) < 0.1] = n3
        tiles.append(runs.astype(np.int32))
        if case == "two_models":
            tiles.append(np.append(rng.integers(0, n3, size=9), n3).astype(np.int32))
    dev = torch.device("cuda")
    extra = None
    if case == "extra":
        extra = torch.from_numpy(rng.uniform(size=n3) < 0.01).to(dev)
    part = Partition(table=torch.from_numpy(table).to(dev), keys=torch.from_numpy(keys).to(dev),
                     count=torch.tensor([count], dtype=torch.int32, device=dev),
                     overflow=torch.zeros(1, dtype=torch.int32, device=dev))
    return (cfg, torch.from_numpy(pool).to(dev), part,
            tuple(torch.from_numpy(t).to(dev) for t in tiles), extra)


@pytest.mark.parametrize("case", ["span2", "span4", "faces", "extra", "overflow",
                                  "dirty_null", "two_models", "empty"])
def test_partition_kernels_match_plain(card, case):
    """The oct-mask, compaction, remap and finalize kernels equal their
    plain twins bit for bit (``chip_smoke.check_partition_kernel``)."""
    cfg, pool, part, tiles, extra = _partition_inputs(case)
    r = card.check_partition_kernel(cfg, pool, part, tiles, case, "test", extra_mask=extra,
                                    time_it=False)
    assert r["max_abs_err"] == 0.0
    assert (r["overflow"] > 0) == (case == "overflow")


@pytest.mark.parametrize("n", [1, 5, 16, 4096, 16384, 3 * 16384 + 123])
@pytest.mark.parametrize("case", ["sparse", "all_false", "all_true", "suffix"])
@pytest.mark.parametrize("size", ["below", "equal", "above"])
def test_first_marked_kernel_matches_plain(card, n, case, size):
    """first_marked equals ``partition._first_marked`` bit for bit, and its
    total the count, where the size lies below, at and above the total, for
    counts that are and are not whole chunks, and on a mark that does not
    start on a 16-byte boundary."""
    import numpy as np

    from claymore_tpu_torch.core import partition
    from claymore_tpu_torch.ops import partition_kernel as pk

    rng = np.random.default_rng(n)
    m = {"sparse": rng.uniform(size=n) < 0.05, "all_false": np.zeros(n, bool),
         "all_true": np.ones(n, bool),
         "suffix": (rng.uniform(size=n) < 0.02) | (np.arange(n) >= n // 3)}[case]
    total = int(m.sum())
    k = {"below": max(total // 2, 1), "equal": max(total, 1), "above": total + 9}[size]
    base = torch.zeros(n + 3, dtype=torch.bool, device="cuda")
    base[3:] = torch.from_numpy(m).cuda()
    for mark in (base[3:].clone(), base[3:]):          # aligned, and 3 bytes off
        idx, tot = pk.first_marked(mark, k, n + 1)
        assert torch.equal(idx, partition._first_marked(mark, k, n + 1))
        assert int(tot[0]) == total and idx.dtype == torch.int64


def test_partition_twins_never_see_a_cuda_tensor(card, monkeypatch):
    """On the card an engine (every substep rebuilding, the incremental
    plan) and a 2x2 mesh (migration, the halo mask, every shard's rebuild)
    run through the partition kernels: the plain twins raise if called,
    and every kernel launches."""
    from claymore_tpu_torch.core import partition
    from claymore_tpu_torch.ops import partition_kernel as pk

    def refuse(name):
        def fn(*args, **kw):
            raise AssertionError(f"the plain {name} ran on the card")
        return fn

    for name in ("_first_marked", "oct_flags", "remap", "rebuild", "finalize_tiles",
                 "particle_blocks"):
        monkeypatch.setattr(partition, name, refuse(name))
    for k in pk.launches:
        pk.launches[k] = 0
    cfg = ct.SimConfig(domain_bits=6, max_active_blocks=512, default_dt=2e-4,
                       rebucket_every=1, defrag_every=2)
    mat = ct.FixedCorotated(volume=cfg.default_volume(), e=1e4, nu=0.3)
    pos = sample_uniform_box_world(cfg.dx, [0.4, 0.45, 0.4], [0.55, 0.6, 0.55], cfg.ppc)
    eng = ct.MPMEngine(cfg, [mat], tile_chunk=8, device="cuda")
    state = eng.run_steps(eng.init_state([pos], [(3.0, -1.0, 2.0)]), 4, 1.0)
    assert eng.rebuilds == 4
    assert pk.launches["oct_mask"] == pk.launches["remap"] == pk.launches["finalize_tiles"] == 5
    assert pk.launches["first_marked"] > 5                 # the incremental plans too
    d = eng.diagnostics(state)
    assert d["model0_active"] == len(pos) and d["null_block_mass"] == 0.0
    before = dict(pk.launches)
    meng, mst, mpos = _multi((2, 2), "cuda")
    mst = meng.run_steps(mst, 4, 1.0)
    md = meng.diagnostics(mst)
    assert md["model0_active"] == mpos.shape[0] and md["migration_dropped"] == 0
    assert all(pk.launches[k] > before[k] for k in pk.launches)


def _halo_on_card(case, mesh):
    """``tests/torch_port_helpers.py:halo_case``'s inputs on the card (NaN
    in a few mass lanes): the comm of a mesh whose shards all live on
    ``cuda``, every shard's pool, partition, model and add target."""
    import numpy as np

    from claymore_tpu_torch.core.types import ParticleModel, Partition
    from claymore_tpu_torch.parallel.multi import HaloComm, LocalGroup
    from torch_port_helpers import halo_case       # tests/ is on the path pytest sets

    c = halo_case(case, mesh, nan=True)
    cfg = ct.SimConfig(**c["cfg_kw"])
    n = len(c["pool"])
    comm = HaloComm(cfg, (("x", 0), ("z", 2))[:len(mesh)], mesh, c["margin"], c["k"], c["h"],
                    group=LocalGroup(mesh, ["cuda"] * n))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()
    pools = [t(p) for p in c["pool"]]
    parts = [Partition(table=t(c["table2"][j]), keys=t(c["keys"][j]),
                       count=torch.tensor([c["count"][j]], dtype=torch.int32, device="cuda"),
                       overflow=torch.zeros(1, dtype=torch.int32, device="cuda"))
             for j in range(n)]
    models = [ParticleModel(pos=t(c["pos"][j]), fields={"F": t(c["F"][j])},
                            active=t(c["active"][j]), pid=t(c["pid"][j]), tiles=None)
              for j in range(n)]
    targets = [(t(c["pool2"][j]), t(c["table2"][j])) for j in range(n)]
    return comm, pools, parts, models, targets


@pytest.mark.parametrize("case", ["plain", "overflow", "empty_shard", "sparse", "mig_overflow"])
@pytest.mark.parametrize("mesh", [(2,), (2, 2), (4, 2)])
def test_halo_kernels_match_plain(card, case, mesh):
    """The halo pack, mass mask, add and migration pack kernels equal their
    plain twins bit for bit (``chip_smoke.check_halo_kernel``) on seeded
    meshes: NaN and -0.0 in the mass lanes, overflowing halo and migration
    capacities, an empty shard, windows with no octs."""
    comm, pools, parts, models, targets = _halo_on_card(case, mesh)
    r = card.check_halo_kernel(comm, pools, parts, models, f"{case} {mesh}", "test",
                               targets=targets, time_it=False)
    assert r["max_abs_err"] == 0.0
    assert (sum(r["overflow"].values()) > 0) == (case == "overflow")
    assert (sum(r["dropped"].values()) > 0) == (case == "mig_overflow")
    assert sum(r["crossers"].values()) > 0


def test_halo_twins_never_see_a_cuda_tensor(card, monkeypatch):
    """A 2x2 mesh on the card rebuilding every substep runs its exchange,
    mass mask, add and migration through the halo kernels: the plain twins
    raise if called, and every kernel launches once per shard (and live
    axis) a substep."""
    from claymore_tpu_torch.ops import halo_kernel as hk
    from claymore_tpu_torch.parallel import halo

    def refuse(name):
        def fn(*args, **kw):
            raise AssertionError(f"the plain {name} ran on the card")
        return fn

    for name in ("window_marks", "pack_marked", "pack_windows", "mass_mask", "add_rows",
                 "migrate_pack"):
        monkeypatch.setattr(halo, name, refuse(name))
    eng, st, pos = _multi((2, 2), "cuda")
    for k in hk.launches:
        hk.launches[k] = 0
    st = eng.run_steps(st, 4, 1.0)
    d = eng.diagnostics(st)
    assert d["model0_active"] == pos.shape[0] and d["migration_dropped"] == 0
    assert d["halo_overflow"] == 0
    assert hk.launches == {"halo_pack": 16, "halo_mask": 16, "halo_add": 16,
                           "migrate_pack": 32}
