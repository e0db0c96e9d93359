"""The ranks of the multi-rank tests: ``tests/test_torch_parallel_mesh.py``,
``tests/test_torch_parallel_sampling.py``, ``tests/test_torch_ddp_training.py``,
``tests/test_torch_scan_mesh.py`` (gloo on the CPU) and
``tests/test_torch_parallel_cuda.py`` (the card).  The tests start them with
:func:`run_ranks`; each rank is

    python tests/torch_parallel_worker.py TASK RANK WORLD PORT DIR

``TASK`` is ``mesh``, ``sampling``, ``ddp``, ``variants``, ``scan`` or
``cuda``.  The rank joins the group
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


# ----------------------------------------------------------------- ddp ---- #
def fingerprint(tensors) -> str:
    """The bytes of every tensor, hashed: equal exactly when the bits are."""
    import hashlib

    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def state_arrays(state) -> dict:
    """A train state's parameters, EMA and Adam moments, each flat."""
    def flat(ts):
        return torch.cat([t.detach().reshape(-1) for t in ts]).numpy()

    opt = state.tx.optimizer.state
    params = list(state.params.values())
    return {"params": flat(params), "ema": flat(list(state.ema_params.values())),
            "exp_avg": flat([opt[p]["exp_avg"] for p in params]),
            "exp_avg_sq": flat([opt[p]["exp_avg_sq"] for p in params])}


def recorded_masks(fn):
    """``fn()`` with every dropout mask it draws recorded, in draw order."""
    import prediff_torch.models.layers as tlayers
    from prediff_torch.ops import dropout

    real, drawn = dropout.keep_mask, []

    def recording(seed, site, tensor, shape, rate, device=None, base=0):
        mask = real(seed, site, tensor, shape, rate, device, base=base)
        drawn.append(mask.numpy())
        return mask

    dropout.keep_mask = tlayers.keep_mask = recording
    try:
        fn()
    finally:
        dropout.keep_mask = tlayers.keep_mask = real
    return drawn


def ddp_task(rank: int, world: int, port: int, out: str) -> None:
    """Two gloo ranks of DDP training on the CPU, each its rows of a global
    batch of 4: the dropout masks, the diffusion trainer's steps, the
    diffusion, alignment and VAE-GAN gradients on injected draws (against
    JAX in the test), the programs with ``--multihost``."""
    from prediff_torch.cli import train_sevirlr_prediff as tp
    from prediff_torch.config import load_config, prediff_default_config
    from prediff_torch.factory import build_training_pipeline, build_unet
    from prediff_torch.models.alignment import NoisyCuboidTransformerEncoder
    from prediff_torch.models.init import init_params_
    from prediff_torch.models.vae import AutoencoderKL
    from prediff_torch.parallel import all_reduce_mean, make_mesh
    from prediff_torch.training import (AlignmentTrainer, DiffusionTrainer, MetricLogger,
                                        VAETrainer, losses)
    from prediff_torch.training import train_state as torch_train_state
    from prediff_torch.training.diffusion_trainer import reduce_loss_dict
    from prediff_torch.utils import checkpoint
    from prediff_torch.utils import distributions as torch_dist

    join(rank, world, port)
    mesh = make_mesh()
    inputs = dict(np.load(os.path.join(out, "inputs.npz")))
    weights = torch.load(os.path.join(out, "weights.pt"))
    spec = json.load(open(os.path.join(out, "spec.json")))
    B = 4
    rows = slice(rank * B // world, (rank + 1) * B // world)
    res = {}

    def T(name):
        return torch.from_numpy(inputs[name])

    # ---- the dropout masks: the rank's rows of one process's, and the control
    cfg = load_config(prediff_default_config, TINY)
    for key in ("attn_drop", "proj_drop", "ffn_drop", "time_embed_dropout"):
        cfg.model.latent_model[key] = 0.1
    unet = init_params_(build_unet(cfg), torch.Generator().manual_seed(3), randomize=True).train()
    x, t, cond = T("mask_x"), T("mask_t").long(), T("mask_cond")
    with torch.no_grad():
        one = recorded_masks(lambda: unet(x, t, cond, dropout_seed=11))
        mine = recorded_masks(lambda: unet(x[rows], t[rows], cond[rows], dropout_seed=11,
                                           dropout_first_row=rows.start))
        base0 = recorded_masks(lambda: unet(x[rows], t[rows], cond[rows], dropout_seed=11))
    for name, masks in (("one", one), ("mine", mine), ("base0", base0)):
        for i, m in enumerate(masks):
            res[f"mask_{name}_{i}"] = m

    # ---- the diffusion trainer: 2 optimizer steps of 2 micro-steps, rates 0.1
    dcfg = load_config(prediff_default_config, TINY)
    for key in ("attn_drop", "proj_drop", "ffn_drop", "time_embed_dropout"):
        dcfg.model.latent_model[key] = 0.1
    optim = dict(lr=1e-3, total_num_steps=10, gradient_clip_val=1.0, warmup_percentage=0.0,
                 accum_steps=2)
    px, py = T("train_x"), T("train_y")

    def trainer_on(m):
        ld = build_training_pipeline(dcfg, device="cpu", params=weights["diffusion_train"])
        return DiffusionTrainer(ld, optim_config=optim, ema_decay=0.9, mesh=m)

    trainer = trainer_on(mesh)
    state = trainer.create_state()
    prints, logs = [], []
    for micro in range(4):
        state, loss_dict = trainer.train_step(state, 5, px[micro, rows], py[micro, rows])
        prints.append(fingerprint(state.tensors()))
        logs.append([float(v) for v in loss_dict.values()])
    res.update({f"train_{k}": v for k, v in state_arrays(state).items()})
    res["train_logs"] = np.array(logs)
    res["train_log_keys"] = np.array(list(loss_dict))
    res["train_prints"] = np.array(prints)
    one_trainer = trainer_on(None)
    one_state = one_trainer.create_state()
    one_logs = []
    for micro in range(4):
        one_state, loss_dict = one_trainer.train_step(one_state, 5, px[micro], py[micro])
        one_logs.append([float(v) for v in loss_dict.values()])
    res.update({f"train_one_{k}": v for k, v in state_arrays(one_state).items()})
    res["train_one_logs"] = np.array(one_logs)
    # the reduction once per optimizer step (the other choice) against every micro-step's
    fresh = trainer_on(mesh)
    st = fresh.create_state()
    local, reduced = [], []
    for micro in range(2):
        st.step = micro
        g, _ = fresh.grads(st, 5, px[micro, rows], py[micro, rows], reduce=False)
        local.append(g)
        reduced.append(all_reduce_mean(g, mesh))
    every = [a + (b - a) / 2 for a, b in zip(*reduced)]    # optax.MultiSteps' running mean
    once = all_reduce_mean([a + (b - a) / 2 for a, b in zip(*local)], mesh)
    res["accum_every"] = torch.cat([g.reshape(-1) for g in every]).numpy()
    res["accum_once"] = torch.cat([g.reshape(-1) for g in once]).numpy()

    # ---- the diffusion loss and gradients at rate 0 on injected draws (JAX in the test)
    ld = build_training_pipeline(load_config(prediff_default_config, TINY), device="cpu",
                                 params=weights["diffusion"])
    lv = T("logvar").requires_grad_(True)
    loss, loss_dict = ld.p_losses(lv, T("z")[rows], T("zc")[rows], T("t")[rows].long(),
                                  T("noise")[rows])
    grads = all_reduce_mean(torch.autograd.grad(loss, list(ld.unet.parameters()) + [lv]), mesh)
    for (name, _), g in zip(list(ld.unet.named_parameters()) + [("logvar", None)], grads):
        res[f"diff_grad/{name}"] = g.numpy()
    for k, v in reduce_loss_dict({**loss_dict, "loss": loss}, mesh).items():
        res[f"diff_loss/{k}"] = v.numpy()

    # ---- the alignment loss and gradients at rate 0 on injected draws
    net = NoisyCuboidTransformerEncoder(**spec["align_net"])
    net.load_state_dict(weights["align_net"])
    vae = AutoencoderKL(**spec["align_vae"])
    vae.load_state_dict(weights["align_vae"])
    atr = AlignmentTrainer(net, vae.eval().requires_grad_(False), timesteps=spec["align_steps"],
                           scale_factor=spec["align_scale"], mesh=mesh)
    ast = atr.create_state()
    eps, frames = T("align_eps"), inputs["align_eps"].shape[0] // B

    def sample(self, generator=None, rows_=None):   # the posterior noise, the rank's rows
        return self.mean + self.std * eps[rows_[0]:rows_[0] + self.mean.shape[0]]

    real_sample = torch_dist.DiagonalGaussianDistribution.sample
    torch_dist.DiagonalGaussianDistribution.sample = sample
    atr._draw = lambda generator, z, r: (T("align_t").long()[r[0]:r[0] + z.shape[0]],
                                          T("align_noise")[r[0]:r[0] + z.shape[0]])
    try:
        grads, loss_dict = atr.grads(ast, 0, T("align_x")[rows], T("align_y")[rows])
    finally:
        torch_dist.DiagonalGaussianDistribution.sample = real_sample
    assert frames * B == eps.shape[0]
    for name, g in zip(ast.params, grads):
        res[f"align_grad/{name}"] = g.numpy()
    for k, v in loss_dict.items():
        res[f"align_loss/{k}"] = v.numpy()

    # ---- two VAE-GAN steps, BatchNorm and ActNorm, and BatchNorm without the reduce
    veps = T("vae_eps")
    torch_dist.DiagonalGaussianDistribution.sample = (
        lambda self, generator=None, rows_=None:
        self.mean + self.std * veps[rows_[0]:rows_[0] + self.mean.shape[0]])
    given = []
    real_apply = torch_train_state.EmaTrainState.apply_gradients

    def recording(self, g):
        given.append([t.clone() for t in g])
        return real_apply(self, g)

    torch_train_state.EmaTrainState.apply_gradients = recording
    real_reduce = losses.all_reduce_sum_grad
    try:
        for case in ("batchnorm", "actnorm", "batchnorm_local"):
            if case == "batchnorm_local":   # each rank's own statistics
                losses.all_reduce_sum_grad = lambda t, m: t * m.size
            vae = AutoencoderKL(**spec["vae"])
            vae.load_state_dict(weights[f"vae_{case.split('_')[0]}"])
            disc = losses.NLayerDiscriminator(input_nc=1, ndf=8, n_layers=1,
                                              use_actnorm=case == "actnorm")
            disc.load_state_dict(weights[f"disc_{case.split('_')[0]}"])
            vtr = VAETrainer(vae, disc, disc_start=1, optim_config=spec["vae_optim"],
                             mesh=mesh, **spec["vae_loss"])
            gen, dst, stats = vtr.create_states()
            given.clear()
            for step in range(2):
                gen, dst, stats, vlogs = vtr.train_step(gen, dst, stats, 1,
                                                        T("vae_x")[rows])
                for k, v in vlogs.items():
                    res[f"{case}/{step}/log/{k}"] = v.numpy()
                for k, v in stats.items():   # live buffers: a copy of this step's
                    res[f"{case}/{step}/stats/{k}"] = v.clone().numpy()
            for step in range(2):
                for kind, params, g in (("gen", gen.params, given[2 * step]),
                                        ("disc", dst.params, given[2 * step + 1])):
                    for name, gv in zip(params, g):
                        res[f"{case}/{step}/{kind}/{name}"] = gv.numpy()
            res[f"{case}/print"] = np.array(fingerprint(gen.tensors() + dst.tensors()))
    finally:
        losses.all_reduce_sum_grad = real_reduce
        torch_train_state.EmaTrainState.apply_gradients = real_apply
        torch_dist.DiagonalGaussianDistribution.sample = real_sample

    # ---- ActNorm's data initialisation on the global batch, and one process's
    for name, m in (("mesh", mesh), ("one", None)):
        disc = losses.NLayerDiscriminator(input_nc=1, ndf=8, n_layers=1, use_actnorm=True)
        disc.reset_parameters(torch.Generator().manual_seed(5))
        disc.data_init(T("vae_x") if m is None else T("vae_x")[rows], m)
        res[f"actnorm_init_{name}"] = torch.cat([p.detach().reshape(-1)
                                                 for p in disc.parameters()]).numpy()

    # ---- the program: --multihost --synthetic --max-steps 2; rank 0 alone writes
    saves, logged = [], []
    real_save, real_log = torch.save, MetricLogger.log
    torch.save = lambda *a, **k: (saves.append(1), real_save(*a, **k))[1]
    MetricLogger.log = lambda self, *a, **k: (logged.append(1), real_log(self, *a, **k))[1]
    save = os.path.join(out, "cli")
    try:
        assert tp.main(["--save", save, "--cfg", TINY, "--synthetic", "--max-steps", "2",
                        "--device", "cpu", "--multihost"]) == 0
    finally:
        torch.save, MetricLogger.log = real_save, real_log
    res["cli_saves"], res["cli_logs"] = np.array(len(saves)), np.array(len(logged))
    cli_cfg = load_config(prediff_default_config, TINY)
    ld = build_training_pipeline(cli_cfg, device="cpu")
    restored = tp.make_trainer(cli_cfg, ld, 10, 1, latent_inputs=False, mesh=mesh).create_state()
    checkpoint.restore_checkpoint(os.path.join(save, "ckpt_last"), restored)
    res["cli_restored_print"] = np.array(fingerprint(restored.tensors()))
    res["cli_restored_step"] = np.array(restored.step)
    np.savez(os.path.join(out, f"ddp{rank}.npz"), **res)


# ---------------------------------------------------------------- scan ---- #
def scan_task(rank: int, world: int, port: int, out: str) -> None:
    """Two gloo ranks of ``DiffusionTrainer.train_step_scan`` on a mesh, each
    its rows of a global batch of 4: one call of K micro-steps against K
    eager ``train_step`` calls on the mesh, at the recipe's rates 0.1, alone
    and with ``remat_unet``, bf16 moments and a bf16 shadow; at rates 0 with
    the global batch's draws injected (the rank's rows), for the JAX scan in
    the test; the program's ``--multihost`` with ``steps_per_call`` 2 and 1."""
    import torch.distributed as dist
    import yaml

    import prediff_torch.diffusion.latent_diffusion as tld
    from prediff_torch.cli import train_sevirlr_prediff as tp
    from prediff_torch.config import load_config, prediff_default_config
    from prediff_torch.factory import build_training_pipeline
    from prediff_torch.parallel import make_mesh
    from prediff_torch.training import DiffusionTrainer

    join(rank, world, port)
    mesh = make_mesh()
    inputs = dict(np.load(os.path.join(out, "inputs.npz")))
    weights = torch.load(os.path.join(out, "weights.pt"))
    spec = json.load(open(os.path.join(out, "spec.json")))
    B, K = 4, spec["k"]
    rows = slice(rank * B // world, (rank + 1) * B // world)
    xs, ys = (torch.from_numpy(inputs[k])[:, rows] for k in ("train_x", "train_y"))
    res = {"rows": np.array([rows.start, rows.stop])}

    def trainer(cfg, params=None, optins=False, track=True):
        kw = dict(spec["optins"]) if optins else {}
        sdtype = kw.pop("state_dtype", None)
        ld = build_training_pipeline(cfg, device="cpu", params=params, seed=4)
        return DiffusionTrainer(ld, optim_config=dict(spec["optim"], state_dtype=sdtype),
                                mesh=mesh, track_grad_norm=track, **kw)

    # ---- the scan against K eager mesh micro-steps, rates 0.1
    cfg = load_config(prediff_default_config, TINY)
    cfg.model.latent_model.update(spec["rates"])
    for name, optins in (("plain", False), ("optins", True)):
        eager, scan = trainer(cfg, optins=optins), trainer(cfg, optins=optins)
        a, b = eager.create_state(), scan.create_state()
        want = []
        for k in range(K):
            a, m = eager.train_step(a, 9, xs[k], ys[k])
            want.append(m)
        b, got = scan.train_step_scan(b, 9, xs, ys)
        res[f"{name}_split"] = np.array(scan.scan_graphs.split)
        res[f"{name}_equal"] = np.array(
            a.counters() == b.counters()
            and all(torch.equal(torch.stack([m[k] for m in want]), got[k]) for k in got)
            and all(p.dtype == q.dtype and torch.equal(p, q)
                    for p, q in zip(a.tensors(), b.tensors())))
        res[f"{name}_print"] = np.array(fingerprint(b.tensors()))
        res[f"{name}_loss"] = got["train/loss"].numpy()
        res[f"{name}_dtypes"] = np.array(sorted({str(t.dtype) for t in b.tensors()}))

    # ---- rates 0, the global batch's draws injected: this rank's rows of them
    real_draws = tld.LatentDiffusion.training_draws

    def injected(self, generator, batch, out_, rows=None):
        first, T = rows[0], self.latent_shape[0]
        got = (inputs["eps"][first * T:(first + batch) * T], inputs["t"][first:first + batch],
               inputs["noise"][first:first + batch])
        for buf, v in zip(out_, got):
            buf.copy_(torch.from_numpy(v))
        return out_

    tld.LatentDiffusion.training_draws = injected
    try:
        cfg0 = load_config(prediff_default_config, TINY)
        tr = trainer(cfg0, params=weights, track=False)
        state, mets = tr.train_step_scan(tr.create_state(), 0, xs, ys)
    finally:
        tld.LatentDiffusion.training_draws = real_draws
    for k, v in mets.items():
        res[f"jax_met/{k}"] = v.numpy()
    for k, p in state.params.items():
        res[f"jax_param/{k}"] = p.detach().numpy()
        res[f"jax_ema/{k}"] = state.ema_params[k].numpy()
    res["jax_counters"] = np.array(state.counters()[:3])

    # ---- the program: --multihost with steps_per_call 2 against 1
    with open(TINY) as f:
        tree = yaml.safe_load(f)
    tree["model"]["latent_model"].update(spec["rates"])
    seen = {}
    real_step, real_scan = DiffusionTrainer.train_step, DiffusionTrainer.train_step_scan

    def spy_step(self, state, seed, x, y):
        seen.setdefault(1, []).append(x.clone())
        return real_step(self, state, seed, x, y)

    def spy_scan(self, state, seed, xs_, ys_):
        seen.setdefault(2, []).append(xs_.clone())
        return real_scan(self, state, seed, xs_, ys_)

    DiffusionTrainer.train_step, DiffusionTrainer.train_step_scan = spy_step, spy_scan
    try:
        for k in (1, 2):
            tree.setdefault("optim", {})["steps_per_call"] = k
            path = os.path.join(out, f"k{k}.yaml")
            if rank == 0:
                with open(path, "w") as f:
                    yaml.safe_dump(tree, f)
            dist.barrier()
            save = os.path.join(out, f"cli{k}")
            assert tp.main(["--save", save, "--cfg", path, "--synthetic", "--max-steps", "4",
                            "--device", "cpu", "--multihost"]) == 0
            dist.barrier()
            st = torch.load(os.path.join(save, "ckpt_last", "step_4.pt"), weights_only=True)
            res[f"cli{k}_print"] = np.array(fingerprint(
                list(st["params"].values()) + list(st["ema_params"].values())))
    finally:
        DiffusionTrainer.train_step, DiffusionTrainer.train_step_scan = real_step, real_scan
    res["cli1_batches"] = torch.stack(seen[1]).numpy()
    res["cli2_chunks"] = torch.stack(seen[2]).numpy()
    np.savez(os.path.join(out, f"scan{rank}.npz"), **res)


# ---------------------------------------------------------------- cuda ---- #
def variants_task(rank: int, world: int, port: int, out: str) -> None:
    """Two gloo ranks of a DDP step of a UNet with global vectors (and the
    global FFNs) at the recipe's rates 0.1, each its rows of a global batch of
    4: the dropout masks drawn (the global vectors' sites among them), the
    reduced gradients of one micro-step and the state after one step, and
    one process's on the whole batch."""
    from prediff_torch.config import load_config, prediff_default_config
    from prediff_torch.factory import build_training_pipeline, build_unet
    from prediff_torch.parallel import make_mesh
    from prediff_torch.training import DiffusionTrainer

    join(rank, world, port)
    mesh = make_mesh()
    inputs = dict(np.load(os.path.join(out, "inputs.npz")))
    weights = torch.load(os.path.join(out, "weights.pt"))
    spec = json.load(open(os.path.join(out, "spec.json")))
    B = 4
    rows = slice(rank * B // world, (rank + 1) * B // world)
    res = {}
    cfg = load_config(prediff_default_config, TINY)
    cfg.model.latent_model.update(spec["latent_model"])
    unet = build_unet(cfg)
    unet.load_state_dict(weights["unet"])
    unet.train()
    x, t, cond = (torch.from_numpy(inputs[k]) for k in ("mask_x", "mask_t", "mask_cond"))
    t = t.long()
    with torch.no_grad():
        one = recorded_masks(lambda: unet(x, t, cond, dropout_seed=11))
        mine = recorded_masks(lambda: unet(x[rows], t[rows], cond[rows], dropout_seed=11,
                                           dropout_first_row=rows.start))
    for name, masks in (("one", one), ("mine", mine)):
        for i, m in enumerate(masks):
            res[f"mask_{name}_{i}"] = m
    optim = dict(lr=1e-3, total_num_steps=10, gradient_clip_val=1.0, warmup_percentage=0.0)
    px, py = torch.from_numpy(inputs["train_x"]), torch.from_numpy(inputs["train_y"])
    for name, m, xs, ys in (("ddp", mesh, px[rows], py[rows]), ("one", None, px, py)):
        ld = build_training_pipeline(cfg, device="cpu", params=weights)
        trainer = DiffusionTrainer(ld, optim_config=optim, mesh=m)
        state = trainer.create_state()
        grads, _ = trainer.grads(state, 5, xs, ys)
        res[f"grads_{name}"] = torch.cat([g.reshape(-1) for g in grads]).numpy()
        state, _ = trainer.train_step(state, 5, xs, ys)
        res[f"state_{name}"] = fingerprint(state.tensors())
        res[f"params_{name}"] = torch.cat([p.detach().reshape(-1)
                                           for p in state.params.values()]).numpy()
    np.savez(os.path.join(out, f"variants{rank}.npz"), **res)


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
    tasks = {"mesh": mesh_task, "sampling": sampling_task, "ddp": ddp_task,
             "variants": variants_task, "scan": scan_task, "cuda": cuda_task}
    tasks[task](int(rank), int(world), int(port), out)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    print(f"WORKER_DONE {task} rank={rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
