"""The ranks of the multi-rank tests: ``tests/test_torch_parallel_mesh.py``,
``tests/test_torch_parallel_sampling.py`` (gloo on the CPU) and
``tests/test_torch_parallel_cuda.py`` (the card).  The tests start them with
:func:`run_ranks`; each rank is

    python tests/torch_parallel_worker.py TASK RANK WORLD PORT DIR

``TASK`` is ``mesh``, ``sampling`` or ``cuda``.  The rank joins the group
through ``prediff_torch.parallel.init_distributed`` at ``localhost:PORT``,
runs the task's checks and leaves its arrays in ``DIR`` for the test to
compare.  JAX and the JAX package are blocked in it: the port imports
neither.  One torch thread, as every test worker.  This module imports
nothing of either package itself.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tiny_smoke.yaml")
CLUSTER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(task: str, out: str, world: int = 2) -> list:
    """``world`` ranks of ``task`` started, writing under ``out``."""
    env = {k: v for k, v in os.environ.items() if k not in CLUSTER_ENV}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = free_port()
    return [subprocess.Popen([sys.executable, __file__, task, str(r), str(world), str(port), out],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             cwd=REPO, env=env) for r in range(world)]


def wait_ranks(procs: list, task: str, timeout: float = 240.0) -> None:
    """Each rank must finish within ``timeout`` seconds (a hung rendezvous
    fails the test) and report its task done; a rank still running is
    killed."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_DONE {task} rank={r}" in text, text[-4000:]


def run_ranks(task: str, out: str, world: int = 2, timeout: float = 240.0) -> None:
    wait_ranks(start_ranks(task, out, world), task, timeout)


def join(rank: int, world: int, port: int) -> None:
    from prediff_torch.parallel import init_distributed

    assert init_distributed(coordinator_address=f"localhost:{port}", num_processes=world,
                            process_id=rank, device="cpu", timeout=60.0)


# ---------------------------------------------------------------- mesh ---- #
def suite_for(rank: int):
    """An eval suite with a cheap FVD feature function, fed this rank's
    members (as ``tests/test_torch_eval_suite.py`` feeds them)."""
    from prediff_torch.datasets.synthetic import synthetic_batch_iterator
    from prediff_torch.evaluation import ForecastEvalSuite, FrechetVideoDistance

    def feat(videos):
        return videos.reshape(videos.shape[0], videos.shape[1], -1).mean(-1)

    suite = ForecastEvalSuite(seq_len=6, threshold_list=(16, 74, 133),
                              fvd=FrechetVideoDistance(feature_fn=feat, num_features=12,
                                                       auto_t=True, reset_real_features=False))
    target = next(synthetic_batch_iterator(batch_size=2, seq_len=6, H=16, W=16, seed=20 + rank))
    rs = np.random.RandomState(30 + rank)
    preds = np.clip(target[None] + 0.1 * rs.randn(3, *target.shape), 0, 1).astype(np.float32)
    suite.update(torch.from_numpy(preds), torch.from_numpy(target))
    return suite


def shard_suite(cfg, path: str):
    """A suite of the program's make holding the state saved at ``path``."""
    from prediff_torch.cli import train_sevirlr_prediff as tp
    from prediff_torch.evaluation import FrechetVideoDistance

    suite = tp.make_suite(cfg, FrechetVideoDistance(feature_fn=lambda v: v, auto_t=True,
                                                    reset_real_features=False))
    suite.load_state_tree(dict(np.load(path)))
    return suite


def eval_args(save: str, data: str, extra=()):
    return ["--save", save, "--cfg", TINY, "--sevir-dir", data, "--device", "cpu", "--test",
            "--num-samples", "2", "--ddim-steps", "2", *extra]


def mesh_task(rank: int, world: int, port: int, out: str) -> None:
    from prediff_torch.cli import train_sevirlr_prediff as tp
    from prediff_torch.datasets import prefetch_to_device
    from prediff_torch.parallel import (all_reduce_sum, gather_batch, make_2d_mesh,
                                        make_data_mesh, make_mesh, replicate, shard_batch)

    res = {}
    data = os.path.join(out, "sevir")
    # the one-process run of this rank's shard of the test events, first
    args = tp.parse_args(eval_args(os.path.join(out, f"shard{rank}"), data))
    cfg = tp.load_config(tp.prediff_default_config, TINY)
    dm = tp.SEVIRDataModule(
        seq_len=cfg.dataset.seq_len, stride=cfg.dataset.stride, layout=cfg.dataset.layout,
        aug_mode=cfg.dataset.aug_mode, dataset_name=cfg.dataset.dataset_name, sevir_dir=data,
        start_date=cfg.dataset.start_date,
        train_test_split_date=cfg.dataset.train_test_split_date, end_date=cfg.dataset.end_date,
        val_ratio=cfg.dataset.val_ratio, batch_size=cfg.optim.micro_batch_size,
        seed=cfg.optim.seed, num_shard=world, rank=rank)
    dm.setup()
    suites = tp.score_test_set(args, cfg, tp.build_models(cfg, args, torch.device("cpu")), dm,
                               os.path.join(out, f"shard{rank}"))
    for name, suite in suites.items():
        np.savez(os.path.join(out, f"shard{rank}_{name}.npz"), **suite.state_tree())

    join(rank, world, port)
    mesh = make_mesh()
    res["jax_blocked"] = [sys.modules.get(n) is None for n in ("jax", "flax", "prediff_tpu")]
    res["port_imported"] = sorted(n for n in sys.modules if n.startswith("prediff_torch."))
    res["mesh"] = [mesh.size, mesh.index, mesh.backend, str(mesh.device)]
    res["data_mesh"] = {}
    for b in (1, 2, 3, 4):
        m = make_data_mesh(b)
        res["data_mesh"][b] = [m.size, m.member]
    res["mesh_2d"] = list(make_2d_mesh(world, 1).mesh.shape)
    x = torch.arange(4 * 3, dtype=torch.float32).reshape(4, 3)
    res["shard"] = shard_batch({"x": x, "y": [x[:, 0]]}, mesh)["x"].tolist()
    res["replicate"] = replicate(torch.full((2,), float(rank + 7)), mesh).tolist()
    res["gather"] = gather_batch(torch.full((1, 2), float(rank)), mesh).tolist()
    res["all_reduce"] = all_reduce_sum(torch.tensor(rank + 0.5), mesh).item()
    res["prefetch"] = [t.tolist() for t in prefetch_to_device(
        iter([x, x + 100]), device="cpu", sharding=mesh)]
    # the group as if made elsewhere (no device recorded): "auto" takes the card, or raises
    from prediff_torch.parallel import mesh as mesh_mod
    from prediff_torch.serving import PreDiffPredictor

    given = dict(mesh_mod._RANK_DEVICE)
    mesh_mod._RANK_DEVICE.clear()
    try:
        PreDiffPredictor(cfg, with_alignment=False)
        res["bare_group_predictor"] = "built"
    except RuntimeError as e:
        res["bare_group_predictor"] = str(e)
    finally:
        mesh_mod._RANK_DEVICE.update(given)

    # cross_process_reduce: the ranks' suites summed
    suite = suite_for(rank)
    np.savez(os.path.join(out, f"suite_before{rank}.npz"), **suite.state_tree())
    suite.cross_process_reduce()
    np.savez(os.path.join(out, f"suite_after{rank}.npz"), **suite.state_tree())
    res["suite_compute"] = suite.compute("test")

    # the program: --test on both ranks, each its shard of the events
    assert tp.main(eval_args(os.path.join(out, "run"), data, ["--multihost"])) == 0
    if rank == 0:   # the merge of the one-process runs of the two shards, in rank order
        merged = {}
        for name in suites:
            shards = [shard_suite(cfg, os.path.join(out, f"shard{r}_{name}.npz"))
                      for r in range(world)]
            for other in shards[1:]:
                shards[0].merge(other)
            merged.update(shards[0].compute("test" if name == "unaligned" else "test_aligned"))
        res["merged_metrics"] = merged
    with open(os.path.join(out, f"mesh{rank}.json"), "w") as f:
        json.dump(res, f)


# ------------------------------------------------------------ sampling ---- #
def recorded(ld, fn):
    """``fn()`` with the latent before each reverse step and the step noise
    it reads (this rank's rows) recorded: ``(out, x_T, noises)``."""
    z, noise = [], []
    step = ld._reverse_step

    def record(s, plan, guided):
        z.append(s.z.clone())
        noise.append(s.noise.clone())
        step(s, plan, guided)

    ld._reverse_step = record
    try:
        out = fn()
    finally:
        del ld._reverse_step
    return out, z[0], torch.stack(noise)


def sampling_task(rank: int, world: int, port: int, out: str) -> None:
    from prediff_torch.config import load_config, prediff_default_config
    from prediff_torch.diffusion import knowledge_alignment
    from prediff_torch.parallel import local_batch_slice
    from prediff_torch.serving import PreDiffPredictor

    join(rank, world, port)
    cfg = load_config(prediff_default_config, TINY)
    state = torch.load(os.path.join(out, "weights.pt"))
    inputs = np.load(os.path.join(out, "inputs.npz"))
    y, x_T, avg = (torch.from_numpy(inputs[k]) for k in ("y", "x_T", "avg"))
    predictor = PreDiffPredictor(cfg, params=state, with_alignment=True, device="cpu")
    assert predictor.mesh is not None and predictor.mesh.size == world   # mesh="auto"
    ld, mesh = predictor.ld, predictor.mesh
    res = {}
    guided = dict(use_alignment=True, alignment_kwargs={"avg_x_gt": avg})
    ddim = dict(sampler="ddim", ddim_steps=4, ddim_eta=0.0)
    chains = (("ddpm", dict(timesteps=4)), ("ddim", ddim), ("guided_ddim", {**ddim, **guided}))
    for name, kw in chains:
        res[name] = ld.sample(y, x_T=x_T, temperature=0.0, mesh=mesh, **kw)
    # one process on this rank's rows alone: a batch the size of the rank's
    rows2 = local_batch_slice(2, world, rank)
    res["ddpm_rows_one"] = ld.sample(y[rows2], x_T=x_T[rows2], temperature=0.0, timesteps=4)
    # the energy of the whole batch from each rank's rows, and from all of them
    t = torch.full((2,), 3)
    res["energy"] = ld.alignment.alignment_energy(x_T[rows2], t[rows2], avg[rows2], mesh=mesh)
    res["energy_one"] = ld.alignment.alignment_energy(x_T, t, avg)
    # the guided chain with the all-reduce left out: each rank's energy alone
    reduce = knowledge_alignment.all_reduce_sum
    knowledge_alignment.all_reduce_sum = lambda t, m: t.clone()
    try:
        res["guided_ddim_no_reduce"] = ld.sample(y, x_T=x_T, temperature=0.0, mesh=mesh,
                                                 **ddim, **guided)
    finally:
        knowledge_alignment.all_reduce_sum = reduce

    # with noise: the ensemble's draws against one process's, from one seed
    y1 = y[:1]
    rows = local_batch_slice(4, world, rank)

    def ensemble():
        return predictor.predict_ensemble(y1, num_samples=4, timesteps=3,
                                          generator=torch.Generator().manual_seed(5))

    res["ens"], res["ens_x_T"], res["ens_noise"] = recorded(ld, ensemble)
    predictor.mesh = None
    res["ens_one"], one_z, one_noise = recorded(ld, ensemble)
    res["ens_one_x_T_rows"], res["ens_one_noise_rows"] = one_z[rows], one_noise[:, rows]
    predictor.mesh = mesh
    # a generator seeded otherwise on rank 1 draws rank 0's numbers all the same
    res["ens_seed_rank"] = predictor.predict_ensemble(
        y1, num_samples=4, timesteps=3, generator=torch.Generator().manual_seed(5 + rank))
    # guided with noise, DDPM: sharded and one process
    kw = dict(num_samples=2, timesteps=3, use_alignment=True, avg_x_gt=avg)
    res["ens_guided"] = predictor.predict_ensemble(y, generator=torch.Generator().manual_seed(6),
                                                   **kw)
    predictor.mesh = None
    res["ens_guided_one"] = predictor.predict_ensemble(
        y, generator=torch.Generator().manual_seed(6), **kw)
    predictor.mesh = mesh
    # a batch the mesh does not divide: whole on every rank
    y3 = torch.cat([y, y[:1] * 0.5])
    res["indivisible"] = ld.sample(y3, timesteps=2, mesh=mesh,   # rank 1 seeded otherwise
                                   generator=torch.Generator().manual_seed(7 + rank))
    res["indivisible_one"] = ld.sample(y3, timesteps=2,
                                       generator=torch.Generator().manual_seed(7))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **{k: v.numpy() for k, v in res.items()})


# ---------------------------------------------------------------- cuda ---- #
def cuda_task(rank: int, world: int, port: int, out: str) -> None:
    """On ``cuda:0``: two gloo ranks (unguided steps on graphs, guided ones
    eager) against one process, or one NCCL rank (the guided step's
    all-reduce captured) against its eager chain and the call without a
    mesh.  Seeded randomized weights at the tiny configuration."""
    import torch.distributed as dist
    from prediff_torch.config import load_config, prediff_default_config
    from prediff_torch.factory import build_alignment_model, build_unet, build_vae
    from prediff_torch.models.init import init_params_
    from prediff_torch.parallel import init_distributed, make_mesh
    from prediff_torch.serving import PreDiffPredictor

    dev = torch.device("cuda", 0)
    assert init_distributed(coordinator_address=f"localhost:{port}", num_processes=world,
                            process_id=rank, backend="gloo" if world > 1 else "nccl",
                            device=dev, timeout=60.0)
    cfg = load_config(prediff_default_config, TINY)
    gen = torch.Generator().manual_seed(3)
    weights = {k: init_params_(build(cfg), gen, randomize=True).state_dict()
               for k, build in (("unet", build_unet), ("vae", build_vae),
                                ("align", build_alignment_model))}
    predictor = PreDiffPredictor(cfg, params=weights, with_alignment=True,
                                 mesh=make_mesh() if world == 1 else "auto")
    mesh, ld = predictor.mesh, predictor.ld
    assert mesh is not None and mesh.size == world and predictor.device.type == "cuda"
    y = torch.rand((1, 3, 32, 32, 1), generator=torch.Generator().manual_seed(4))
    avg = np.array([[0.4]], np.float32)
    res = {}

    def both(name, **kw):
        """The forecast with the mesh and with none (one process), from one seed."""
        def run():
            return predictor.predict_ensemble(
                y, generator=torch.Generator(dev).manual_seed(5), **kw).cpu()

        predictor.mesh = mesh
        captures = ld.graphs.captures
        res[name] = run()
        res[name + "_captures"] = torch.tensor(ld.graphs.captures - captures)
        predictor.mesh = None
        res[name + "_one"] = run()
        predictor.mesh = mesh

    guided = dict(num_samples=4, ddim_steps=4, use_alignment=True, avg_x_gt=avg)
    if world > 1:
        both("ddpm", num_samples=4, timesteps=4)
        both("guided", **guided)
        routes = [k[-1][-1] for k in ld.graphs._entries if k[-1] is not None]
        res["routes"] = torch.tensor([r == "eager" for r in routes])
    else:
        calls = []
        all_reduce = dist.all_reduce

        def counted(*args, **kwargs):
            calls.append(torch.cuda.is_current_stream_capturing())
            return all_reduce(*args, **kwargs)

        dist.all_reduce = counted
        try:
            both("guided", **guided)
        finally:
            dist.all_reduce = all_reduce
        with ld._plain_chain():
            res["guided_eager"] = predictor.predict_ensemble(
                y, generator=torch.Generator(dev).manual_seed(5), **guided).cpu()
        res["captured_all_reduce"] = torch.tensor(sum(calls))
    np.savez(os.path.join(out, f"cuda{world}_rank{rank}.npz"),
             **{k: v.numpy() for k, v in res.items()})


def main() -> int:
    sys.path.insert(0, REPO)
    for name in ("jax", "jaxlib", "flax", "prediff_tpu"):
        sys.modules[name] = None   # an import of any of them raises ImportError
    task, rank, world, port, out = sys.argv[1:6]
    torch.set_num_threads(1)
    tasks = {"mesh": mesh_task, "sampling": sampling_task, "cuda": cuda_task}
    tasks[task](int(rank), int(world), int(port), out)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    print(f"WORKER_DONE {task} rank={rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
