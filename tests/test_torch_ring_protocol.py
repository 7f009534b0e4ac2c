"""A model of the mbarrier rings of the port's wgmma kernels (K3's
``ssd_scan_wgmma_kernel``, K2's ``flash_fwd_wgmma_kernel``), checked on the
CPU against the contract in ``kernels/csrc/ptx.cuh``: every wait names its
barrier's current phase or the one just before it.

This is a model, not the kernels: a barrier here has the semantics the PTX
ISA gives ``mbarrier`` (phases, an arrival count, transaction bytes, and
``try_wait.parity``, true once the barrier's current phase has another
parity than the one named), and the producer and the consumer warpgroups
are Python generators that replay the kernels' item walks (K3's ``work()``
order, its fills and its waits; K2's key tiles, split between the
warpgroups or not). A scheduler interleaves them and lands the TMA copies
in adversarial orders: while everything else waits, the newest first, or
an odd item's copy before an older even item's (a stage's copy held back
until the next stage's has landed and been consumed), or at random. The proof that the kernels keep the contract on the card is the
stress there (``tools/kernel_stress.py``, ``chip_smoke.py``'s
``phase_stress``); this test shows why the schedule should, and that the
schedule the rings were first written with (one full barrier a stage,
waited for by the item's parity; marked ``shared_full`` here) does not.
"""
from __future__ import annotations

import random
import re
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
K3_SRC = (CSRC / "ssd_scan.cu").read_text()
K2_SRC = (CSRC / "flash_attention.cu").read_text()
WG_STAGES = int(re.search(r"constexpr int WG_STAGES = (\d+);", K3_SRC).group(1))
SMS = 132   # the H100's SMs: the persistent grid of K3 is min(work items, SMs)


def k2_stages(d, ksplit):
    """WgTile<D, KSPLIT>::STAGES, as flash_attention.cu writes it."""
    return 4 if d == 64 else (3 if d == 128 or ksplit else 2)


class Barrier:
    """One mbarrier: `count` arrivals and the expected transaction bytes
    complete a phase. `phase` is the index of the current (incomplete)
    phase, the number completed so far."""

    def __init__(self, name, count):
        self.name, self.count = name, count
        self.phase, self.pending, self.tx = 0, count, 0
        self.arrivals = [0]    # arrivals on each phase
        self.fills = 0         # arrive.expect_tx made on it
        self.faults = []

    def arrive(self, n=1, tx=0):
        if n > self.pending:
            self.faults.append(f"{self.name}: {n} arrivals on phase {self.phase}, "
                               f"which has {self.pending} left")
            n = self.pending
        self.pending -= n
        self.arrivals[-1] += n
        self.tx += tx
        self._complete()

    def land(self, nbytes):
        self.tx -= nbytes
        self._complete()

    def _complete(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count
            self.arrivals.append(0)

    def try_wait(self, k):
        """(the hardware's answer to a wait for phase k, which names it by
        parity alone; whether k is a phase the contract lets a wait name)."""
        return (k & 1) != (self.phase & 1), self.phase - 1 <= k <= self.phase


class Sim:
    """Processes (generators of ops) over barriers, copies in flight and
    stages. Ops: ("wait", bar, k), ("arrive", bar, n), ("fill", bar,
    nbytes) (arrive once expecting nbytes), ("copy", bar, nbytes, stage,
    item), ("read", stage, item), ("sync", name, parties)."""

    def __init__(self, procs, policy, seed=0):
        self.procs = dict(procs)
        self.op = {p: next(g, None) for p, g in self.procs.items()}
        self.policy, self.rng = policy, random.Random(seed)
        self.copies, self.content, self.violations = [], {}, []
        self.sync_count, self.sync_gen, self.at_sync = {}, {}, {}

    def _runnable(self, p):
        op = self.op[p]
        if op is None:
            return False
        if op[0] == "wait":
            ok, legal = op[1].try_wait(op[2])
            if not legal:
                self.violations.append(
                    f"{p}: wait for phase {op[2]} of {op[1].name} at its phase {op[1].phase}"
                    + (" returned at once" if ok else " can never return"))
            return ok
        if op[0] == "sync":
            return p in self.at_sync and self.sync_gen[op[1]] > self.at_sync[p]
        return True

    def _step(self, p):
        op = self.op[p]
        kind = op[0]
        if kind == "sync" and p not in self.at_sync:
            name, parties = op[1], op[2]
            self.at_sync[p] = self.sync_gen.setdefault(name, 0)
            self.sync_count[name] = self.sync_count.get(name, 0) + 1
            if self.sync_count[name] == parties:
                self.sync_count[name] = 0
                self.sync_gen[name] += 1
            return
        if kind == "sync":
            del self.at_sync[p]
        elif kind == "arrive":
            op[1].arrive(op[2])
        elif kind == "fill":
            op[1].fills += 1
            op[1].arrive(1, op[2])
        elif kind == "copy":
            self.copies.append(op[1:])
        elif kind == "read" and self.content.get(op[1]) != op[2]:
            self.violations.append(f"{p}: read {op[1]} for item {op[2]}, which holds "
                                   f"{self.content.get(op[1])}")
        self.op[p] = next(self.procs[p], None)

    def _land(self, i):
        bar, nbytes, stage, item = self.copies.pop(i)
        self.content[stage] = item
        bar.land(nbytes)

    def _pick(self):
        """The copy to land: the newest (lifo), the oldest odd item's, else
        the oldest (hold), the oldest (fifo)."""
        if self.policy == "lifo":
            return len(self.copies) - 1
        if self.policy == "hold":
            return next((i for i, c in enumerate(self.copies) if c[3] % 2), 0)
        return 0

    def run(self, max_steps=2_000_000):
        for _ in range(max_steps):
            ready = [p for p in self.op if self._runnable(p)
                     or (self.op[p] and self.op[p][0] == "sync" and p not in self.at_sync)]
            if self.violations:
                return "violation"
            if self.policy == "random":
                choices = [("p", p) for p in ready] + [("c", i) for i in range(len(self.copies))]
                if not choices:
                    break
                kind, x = self.rng.choice(choices)
                self._step(x) if kind == "p" else self._land(x)
            elif ready:
                self._step(ready[0])
            elif self.copies:   # everything waits: land a copy
                self._land(self._pick())
            else:
                break
        return "done" if all(op is None for op in self.op.values()) else "deadlock"


class Ring:
    """A ring's barriers as the kernels build them (ptx.cuh's Ring):
    full[set][stage] with one arrival a phase, empty[stage] with `releases`;
    `shared_full`: one full barrier a stage for every set, waited for by
    the item's parity (the schedule the rings were first written with)."""

    def __init__(self, name, stages, sets, releases, shared_full=False):
        self.name, self.stages, self.shared_full = name, stages, shared_full
        self.full = [[Barrier(f"{name}.full[{c}][{s}]", 1) for s in range(stages)]
                     for c in range(1 if shared_full else sets)]
        self.empty = [Barrier(f"{name}.empty[{s}]", releases) for s in range(stages)]

    def _full(self, c, s):
        return self.full[0 if self.shared_full else c][s]

    def fill(self, k, c, nbytes):
        """The producer's ops for item k of set c: its stage's release of
        item k - STAGES, the arrive, the copy."""
        s = k % self.stages
        if k >= self.stages:
            yield ("wait", self.empty[s], k // self.stages - 1)
        yield ("fill", self._full(c, s), nbytes)
        yield ("copy", self._full(c, s), nbytes, (self.name, s), k)

    def take(self, k, c, phases, releases):
        """A consumer warpgroup of set c: wait for item k, read its stage,
        release it (`releases` arrivals: 128 a warpgroup). `phases` is the
        set's count of waits on each stage (RingPhases)."""
        s = k % self.stages
        n = k // self.stages if self.shared_full else phases[s]
        phases[s] += 1
        yield ("wait", self._full(c, s), n)
        yield ("read", (self.name, s), k)
        yield ("arrive", self.empty[s], releases)

    def barriers(self):
        return [b for row in self.full for b in row] + self.empty

    def check_releases(self):
        """Each stage's empty barrier completed a phase for every item
        filled into it (every item was released, once)."""
        for s in range(self.stages):
            assert self.empty[s].phase == sum(row[s].fills for row in self.full), self.empty[s].name


def k3_walk(bb, h, n_state, L, grid, block):
    """The work items of one block of ssd_scan_wgmma_kernel in its walk
    order (work(): w = block, block + grid, ..; per (batch, head group) the
    state's boxes first, then query tiles nq - 1 .. 0): (w, job, ytile)."""
    hg = 2 if h % 2 == 0 else 1
    nq, nbox = -(-L // 64), -(-n_state // 64)
    n_bg = bb * (h // hg)
    for w in range(block, (nq + nbox) * n_bg, grid):
        k = w // n_bg
        job = nq + k if k < nbox else nq - 1 - (k - nbox)
        yield w, job, job < nq


def k3_block(bb, s, h, n_state, L, grid, block, shared_full):
    """The producer and the two consumer warpgroups of one K3 block, and
    its rings (key tiles: 3 stages, a tile for one warpgroup; C tiles: one
    stage for both)."""
    hg = 2 if h % 2 == 0 else 1
    nq, nbox, n_chunks = -(-L // 64), -(-n_state // 64), -(-s // L)
    box = 64 * 128
    keys = Ring("key", WG_STAGES, 2, 128, shared_full)
    ctile = Ring("C", 1, 1, 256, shared_full)
    walk = list(k3_walk(bb, h, n_state, L, grid, block))

    def producer():
        item = cl = 0
        for _, job, ytile in walk:
            for c in range(n_chunks):
                if ytile:
                    yield from ctile.fill(cl, 0, nbox * box)
                    cl += 1
                    for u in range(job + 1):
                        yield from keys.fill(item, u & 1, (nbox + hg) * box)
                        item += 1
                if not ytile or c + 1 < n_chunks:
                    for u in range(nq):
                        for j in range(hg):
                            yield from keys.fill(item, j & 1, ((nbox if ytile else 1) + 1) * box)
                            item += 1

    def consumer(wg):
        item = cl = 0
        kph, cph = [0] * WG_STAGES, [0]
        for _, job, ytile in walk:
            for c in range(n_chunks):
                yield ("sync", "cum", 2)             # bar_sync(1, 256) around the prefix of log a
                if ytile:
                    k_c = cl
                    s_c = ctile.take(k_c, 0, cph, 128)
                    yield next(s_c)                  # wait for the C tile
                    yield next(s_c)                  # read it
                    for u in range(wg, job + 1, 2):
                        yield from keys.take(item + u, wg, kph, 128)
                    item += job + 1
                    yield next(s_c)                  # release the C tile (both warpgroups: 256)
                    cl += 1
                    yield ("sync", "merge", 2)       # bar_sync(1, 256) before the merge of y
                if not ytile or c + 1 < n_chunks:
                    for j in range(wg, hg, 2):
                        for u in range(nq):
                            yield from keys.take(item + u * hg + j, wg, kph, 128)
                    item += nq * hg

    procs = {"producer": producer(), "wg0": consumer(0), "wg1": consumer(1)}
    return procs, [keys, ctile], []


def k2_block(n_tiles, d, ksplit, shared_full):
    """The producer and the two consumer warpgroups of one K2 block: Q once,
    then the K/V tiles, split between the warpgroups (tile i for i % 2) or
    taken by both (empty counts 256)."""
    stages = k2_stages(d, ksplit)
    kv = Ring("kv", stages, 2 if ksplit else 1, 128 if ksplit else 256, shared_full)
    qbar = Barrier("q", 1)
    tile = 2 * (d // 64) * 64 * 128

    def producer():
        yield ("fill", qbar, 1)
        yield ("copy", qbar, 1, ("Q", 0), 0)
        for i in range(n_tiles):
            yield from kv.fill(i, i % 2 if ksplit else 0, tile)

    def consumer(wg):
        phases = [0] * stages
        yield ("wait", qbar, 0)
        for i in range(wg if ksplit else 0, n_tiles, 2 if ksplit else 1):
            yield from kv.take(i, wg if ksplit else 0, phases, 128)
        if ksplit:
            yield ("sync", "merge", 2)

    procs = {"producer": producer(), "wg0": consumer(0), "wg1": consumer(1)}
    return procs, [kv], [qbar]


def run(procs, rings, others, policy, seed=0):
    sim = Sim(procs, policy, seed)
    status = sim.run()
    faults = [f for b in [*others, *(b for r in rings for b in r.barriers())] for f in b.faults]
    return status, sim.violations, faults


def assert_clean(procs, rings, others, policy, seed=0):
    status, violations, faults = run(procs, rings, others, policy, seed)
    assert not violations, violations[:3]
    assert not faults, faults[:3]
    assert status == "done", status
    for r in rings:
        r.check_releases()
    for b in [*others, *(b for r in rings for b in r.barriers())]:
        # every phase got exactly its arrivals, none is left half full, and a
        # full barrier completed one phase for each fill
        assert all(n == b.count for n in b.arrivals[:-1]), (b.name, b.arrivals)
        assert b.arrivals[-1] == 0 and b.pending == b.count and b.tx == 0, b.name
        if b.fills:
            assert b.phase == b.fills, (b.name, b.phase, b.fills)


POLICIES = ["lifo", "hold", "fifo"] + [f"random{i}" for i in range(4)]


def _policy(p):
    return ("random", int(p[6:])) if p.startswith("random") else (p, 0)


# (Bb, S, H, N, chunk): mamba2-2.7b's widths at the one-shot path's Bb 4 and
# at 16; three chunks (the scratch state, the state items inside y items);
# odd H (one head a block: every state tile for warpgroup 0)
K3_SHAPES = {"mamba2_bb4": (4, 256, 80, 128, 256), "mamba2_bb16": (16, 256, 80, 128, 256),
             "three_chunks": (2, 600, 4, 128, 256), "odd_heads": (2, 128, 3, 64, 128)}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("grid_block", [(SMS, 0), (SMS, SMS - 1), (7, 3), (1, 0)],
                         ids=lambda gb: f"grid{gb[0]}-block{gb[1]}")
@pytest.mark.parametrize("shape", list(K3_SHAPES))
def test_k3_rings_keep_the_contract(shape, grid_block, policy):
    bb, s, h, n_state, L = K3_SHAPES[shape]
    grid, block = grid_block
    n_work = (-(-L // 64) + -(-n_state // 64)) * bb * (h // (2 if h % 2 == 0 else 1))
    grid = min(grid, n_work)
    assert_clean(*k3_block(bb, s, h, n_state, L, grid, min(block, grid - 1), shared_full=False),
                 *_policy(policy))


# (B, S): gemma-2b's heads (MQA 8/1, D 256) at the one-shot path's B 4 (the
# key tiles split: 4 tiles a block), at B 1, S 1024 (split, 16 tiles) and at
# B 16 (not split); D 128 split (3 stages) and D 64 split (4 stages)
K2_CASES = {"gemma_b4": (4, 256, True), "gemma_b1_s1024": (16, 256, True),
            "gemma_b16": (4, 256, False), "d128_split": (9, 128, True),
            "d64_split": (9, 64, True), "d128_whole": (9, 128, False)}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_ring_keeps_the_contract(case, policy):
    n_tiles, d, ksplit = K2_CASES[case]
    assert_clean(*k2_block(n_tiles, d, ksplit, shared_full=False), *_policy(policy))


def test_k2_gemma_launches_take_the_split_as_modelled():
    """launch_wgmma_dim splits the key tiles where 4 x query blocks x B x
    (H / G) < 3 x 132: gemma-2b (MQA 8/1, G 8, 16 positions a block pair)
    at B 4, S 256 and B 1, S 1024 splits, at B 16 it does not."""
    assert "4LL * ((sq + 128 / G - 1) / (128 / G)) * B * (H / G) < 3 * 132" in K2_SRC
    split = lambda b, s: 4 * -(-s // 16) * b * 1 < 3 * 132
    assert split(4, 256) and split(1, 1024) and not split(16, 256)


@pytest.mark.parametrize("shape", ["mamba2_bb4", "mamba2_bb16"])
def test_k3_shared_full_schedule_breaks_the_contract(shape):
    """The schedule of the first K3 wgmma kernel (shared_full): consecutive
    key tiles of a stage go to different warpgroups, both wait on one full
    barrier by the item's parity. With a stage's copy held back until the
    next stage's has landed and been consumed, a warpgroup waits for the
    phase after the barrier's current one and returns at once: the wait
    that, on the card, let a consumer read a stage before its copy and
    knocked the arrivals out of step (a trap within a few hundred launches).
    """
    bb, s, h, n_state, L = K3_SHAPES[shape]
    for policy in ("lifo", "hold"):
        status, violations, _ = run(*k3_block(bb, s, h, n_state, L, SMS, 0, shared_full=True),
                                    policy)
        assert status == "violation", policy
        assert "returned at once" in violations[0] and "key.full[0]" in violations[0], violations


@pytest.mark.parametrize("case,broken", [("gemma_b4", True), ("gemma_b1_s1024", True),
                                         ("d128_split", True), ("d64_split", False),
                                         ("gemma_b16", False)])
def test_k2_shared_full_schedule(case, broken):
    """K2's first wgmma kernel had the same shared full barrier. With the key
    tiles split over 3 stages (D 128 and 256: gemma's one-shot shape) tiles
    i and i + 3 share a stage and go to different warpgroups, and the
    adversary breaks the contract; at 4 stages (D 64) a stage's tiles all go
    to one warpgroup, and unsplit both wait for every phase in order, so
    those schedules kept it."""
    n_tiles, d, ksplit = K2_CASES[case]
    if broken:
        status, violations, _ = run(*k2_block(n_tiles, d, ksplit, shared_full=True), "hold")
        assert status == "violation" and "returned at once" in violations[0], violations
    else:
        for policy in POLICIES:
            assert_clean(*k2_block(n_tiles, d, ksplit, shared_full=True), *_policy(policy))


def test_sources_follow_the_modelled_schedule():
    """The model's walk is the kernels': K3 fills key tile u of a y item for
    warpgroup u % 2 and (tile, head j) of a state item for j % 2, each
    warpgroup waits on its own full barriers (Ring<STAGES, 2>) and both on
    the C tile's (Ring<1, 1>); K2 fills tile i for i % 2 when split."""
    assert "push(c0, u, nbox, 0, HG, u & 1)" in K3_SRC
    assert "push(c0, u, it.nbx, j, j + 1, j & 1)" in K3_SRC
    assert "Ring<STAGES, 2, 0> kring" in K3_SRC and "Ring<1, 1, 1> cring" in K3_SRC
    assert "kring.wait(k, wg, kph, w)" in K3_SRC and "cring.wait(cl, 0, cph, w)" in K3_SRC
    assert "for (int u = wg; u <= job; u += 2)" in K3_SRC
    assert "kv.fill(i, KSPLIT ? i % NC : 0" in K2_SRC
    assert "kv.wait(i, KSPLIT ? wg : 0, ph" in K2_SRC
    assert "Ring<STAGES, KSPLIT ? NC : 1> kv" in K2_SRC
    assert "static constexpr int STAGES = D == 64 ? 4 : (D == 128 || KSPLIT ? 3 : 2);" in K2_SRC
    ptx = (CSRC / "ptx.cuh").read_text()
    assert "const uint32_t parity = (phases >> s) & 1;" in ptx


def test_barrier_model_parity_semantics():
    """try_wait.parity as the PTX ISA has it: a wait for the phase after the
    current one returns at once, one for two phases back never returns;
    the contract allows neither. An arrival past a phase's count is a fault."""
    b = Barrier("b", 1)
    assert b.try_wait(0) == (False, True)        # the current phase, not complete
    assert b.try_wait(1) == (True, False)        # a phase ahead: returns at once
    b.arrive()
    assert b.phase == 1 and b.try_wait(0) == (True, True)
    b.arrive()
    b.arrive()
    assert b.phase == 3 and b.try_wait(1) == (False, False)   # two back: never
    t = Barrier("t", 1)
    t.arrive(1, tx=8)
    assert t.phase == 0
    t.land(8)
    assert t.phase == 1
    t.pending = 0
    t.arrive()
    assert t.faults
