"""Rank bodies for ``tests/test_torch_sharded_serving.py`` (torch only: the
ranks are spawned processes and never import JAX).

:func:`serve_meshes` runs on every rank of one ``gloo`` world on the CPU:
for each mesh shape it is given it builds the mesh over that world, then
drives the port's backends through the orchestrator (the reference's
parity drives) and returns what the parent compares: token streams, the
rank's block of each final cache tree, sentinel counts, the prefix
store's hits, sizes and evictions, and one counted decode step.
"""
from __future__ import annotations

import torch

from repro_torch.analysis import CompileSentinel, SyncSentinel
from repro_torch.convert import params_from_numpy
from repro_torch.launch.mesh import init_mesh
from repro_torch.roofline.counter import WorkCounter
from repro_torch.serving.backend import make_backend
from repro_torch.serving.orchestrator import Orchestrator, SchedulerConfig
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.tree import tree_leaves_with_path

PROMPTS = [list(range(7 + i, 39 + i)) for i in range(3)]
NEW_PROMPT = list(range(60, 140))      # stores a 64-token prefix
KW = dict(slots=2, capacity=128, pool_pages=512, device="cpu")
TEMPERATURE = 0.7


def host_tree(tree):
    """{path: numpy} of a cache tree."""
    return {tuple(str(k) for k in p): x.numpy().copy()
            for p, x in tree_leaves_with_path(tree)}


def drive(eng, depth, *, sentinels=False, prefix_cache=None):
    """The three prompts through ``eng`` (4 new tokens each, chunk 16)."""
    orch = Orchestrator(eng, sched=SchedulerConfig(chunk_tokens=16,
                                                   dispatch_ahead=depth),
                        prefix_cache=prefix_cache)
    for p in PROMPTS:
        orch.submit(p, max_new=4)
    out = {}
    if sentinels:
        with CompileSentinel(eng) as cs, SyncSentinel(eng) as ss:
            orch.run()
            out["compiled"] = cs.check()
        out["collect_syncs"] = ss.syncs_in_collect
    else:
        orch.run()
    out["tokens"] = [orch.tokens(r) for r in range(len(PROMPTS))]
    return out


def serve_all(cfg, params, mesh):
    """Every drive on one mesh."""
    engines = {}

    def eng_for(name, **kw):
        key = (name,) + tuple(sorted(kw.items()))
        if key not in engines:
            engines[key] = make_backend(name, params, cfg, mesh=mesh,
                                        mirror_paged=name == "wgkv",
                                        **KW, **kw)
        return engines[key]

    out = {}
    # wgkv: round 1 of a prefix store (dispatch_ahead 0), then round 2
    # (dispatch_ahead 1), which hits every prompt
    eng = eng_for("wgkv")
    pc = PrefixCache(quantum=16, free_fn=eng.release_prefix)
    out["wgkv"] = drive(eng, 0, sentinels=True, prefix_cache=pc)
    out["wgkv"]["caches"] = host_tree(eng.caches)
    out["wgkv_async"] = drive(eng, 1, sentinels=True, prefix_cache=pc)
    out["prefix"] = {"hits": pc.hits, "misses": pc.misses}
    out["prefix_evict"] = evict_drive(eng, pc)
    dense = eng_for("dense")
    out["dense"] = drive(dense, 0, sentinels=True)
    out["dense"]["caches"] = host_tree(dense.caches)
    out["wgkv_sel_all"] = drive(eng_for("wgkv", selection="quest:8"), 1,
                                sentinels=True)
    out["wgkv_temp"] = drive(eng_for("wgkv", temperature=TEMPERATURE,
                                     seed=5), 1)
    # deadlines: every rank cancels what rank 0's clock expired; the pool
    # on the mesh, with the one request that lives in decode, settled
    orch = Orchestrator(eng, sched=SchedulerConfig(chunk_tokens=16))
    rids = [orch.submit(p, max_new=4, deadline_s=d)
            for p, d in zip(PROMPTS, (1e-9, 600.0, 1e-9))]
    while orch.queue.requests[rids[1]].state != "decode":
        orch.tick()
    orch.drain()
    out["paged_dev"] = eng.verify_paged()
    orch.run()
    out["deadline"] = [orch.queue.requests[r].state for r in rids]
    out["sharded"] = eng.capabilities().sharded
    out["devices"] = eng.memory_snapshot().get("mesh_devices")
    return out, eng


def evict_drive(eng, pc):
    """The store after round 2 holds the three prompts' 16-token prefixes
    (their global caches empty). Its budget becomes its size (the largest
    over the mesh), then a new prompt is served: its 64-token prefix,
    whose heads admitted different counts, evicts the two least recently
    used entries, and the first prompt, served again, misses and evicts
    the third. Returns the sizes of the entries left, the store's
    counters and the last tokens."""
    pc.budget_bytes = int(eng._mesh_max(pc.bytes_used))
    orch = Orchestrator(eng, sched=SchedulerConfig(chunk_tokens=16),
                        prefix_cache=pc)
    orch.submit(NEW_PROMPT, max_new=1)
    orch.run()
    rid = orch.submit(PROMPTS[0], max_new=4)
    orch.run()
    return {"n_bytes": [e.n_bytes for e in pc._entries.values()],
            "hits": pc.hits, "misses": pc.misses,
            "evictions": pc.evictions, "tokens": orch.tokens(rid)}


def counted_decode_step(eng):
    """Both slots live, then two decode-only fused steps, one under each
    mode of the work counter (aten ops counted, and not): each one's
    collective bytes, in all and by mesh axis, and kernel launches."""
    for slot, p in enumerate(PROMPTS[:2]):
        eng.insert(eng.prefill(p), slot)
    out = []
    for aten in (True, False):
        with WorkCounter(aten=aten) as wc:
            eng.collect(eng.step_batch([]))
        rec = wc.record()
        out.append((rec["collective_bytes"], rec["collective_bytes_by_axis"],
                    {k: v["launches"] for k, v in rec["kernels"].items()}))
    for slot in range(2):
        eng.free_slot(slot)
    return out


def serve_meshes(world_mesh, cfg, params_np, shapes):
    """The rank body: for each of ``shapes`` (over this world), the
    drives of :func:`serve_all`; on 1 x 2 also a counted decode step."""
    torch.set_num_threads(1)
    params = params_from_numpy(params_np, cfg, "cpu")
    results = {}
    for shape in shapes:
        mesh = world_mesh if tuple(shape) == (
            world_mesh.shape["data"], world_mesh.shape["model"]) \
            else init_mesh(shape, backend="gloo", device="cpu")
        out, eng = serve_all(cfg, params, mesh)
        out["rows"] = (eng._rows.start, eng._rows.stop)
        out["kv_heads"] = eng.plan.kv_heads
        out["attn"] = eng.plan.attn
        if tuple(shape) == (1, 2):
            out["counted"] = counted_decode_step(eng)
        results[tuple(shape)] = out
    return results


def flat_temperature(cfg, params_np):
    """The port's flat engine on the temperature drive."""
    eng = make_backend("wgkv", params_from_numpy(params_np, cfg, "cpu"), cfg,
                       mirror_paged=False, temperature=TEMPERATURE, seed=5,
                       **KW)
    return drive(eng, 1)["tokens"]

