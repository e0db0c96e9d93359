"""The port's programs on the CPU, part 1 (``configs/tiny_smoke.yaml``,
in-process through ``main([...])``): ``sample_prediff`` (the files and
shapes ``tests/test_cli_smoke.py`` asserts of the JAX script, the forecasts
bit-equal to ``LatentDiffusion.sample`` with the generators the program
derives, and that derivation pinned), ``convert_pretrained`` against the
JAX converter (``load_pretrained_torch`` + ``save_params_npz``: the same
keys, bit-equal) and back through ``flax_params_to_torch``,
``downsample_sevir`` against the JAX loader's writer, the refusals, and no
import of JAX from ``prediff_torch`` or ``chip_smoke.py``."""
import ast
import importlib
import os
import re
import subprocess
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

from prediff_torch.cli import convert_pretrained, downsample_sevir, sample_prediff
from prediff_torch.cli import train_sevirlr_prediff
from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.datasets import make_synthetic_sevir_lr
from prediff_torch.diffusion.knowledge_alignment import get_alignment_kwargs_avg_x
from prediff_torch.factory import build_alignment_model, build_unet, build_vae
from prediff_torch.models.init import init_params_
from prediff_torch.training.diffusion_trainer import step_generator
from prediff_torch.utils.checkpoint import PRETRAINED_NAMES, load_flax_npz
from prediff_torch.utils.convert import flax_params_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tiny_smoke.yaml")


PROGRAMS = ("sample_prediff", "train_sevirlr_prediff", "train_vae_sevirlr", "train_sevirlr_avg_x",
            "precompute_latents", "convert_pretrained", "downsample_sevir", "learning_check")


@pytest.mark.parametrize("name", PROGRAMS)
def test_flags_are_the_jax_scripts_plus_device(name, capsys):
    """``--help`` lists the JAX script's flags and ``--device``; each flag
    has the script's default."""
    with open(os.path.join(REPO, "scripts", f"{name}.py")) as f:
        want = dict(re.findall(r'add_argument\(\s*"(--[\w-]+)"(?:[^)]*?default=([^,)]+))?',
                               f.read()))
    module = importlib.import_module(f"prediff_torch.cli.{name}")
    with pytest.raises(SystemExit):
        module.parse_args(["--help"])
    assert set(re.findall(r"(--[\w-]+)", capsys.readouterr().out)) - {"--help"} == \
        set(want) | {"--device"}
    required = {"precompute_latents": ["--out", "x.h5"], "convert_pretrained": ["--pt-dir", "pt"],
                "downsample_sevir": ["--sevir-dir", "a", "--out", "b"]}.get(name, [])
    got = vars(module.parse_args(required))
    for flag, default in want.items():
        if default:
            assert got[flag[2:].replace("-", "_")] == ast.literal_eval(default), flag


def test_sample_writes_the_forecasts_of_the_library_call(tmp_path):
    out = str(tmp_path / "forecasts")
    argv = ["--out", out, "--cfg", TINY, "--synthetic", "--num-samples", "2",
            "--use-alignment", "--ddim-steps", "2", "--vis", "--device", "cpu"]
    assert sample_prediff.main(argv) == 0
    assert {"ctx0_sample0.npy", "ctx0_sample1.npy", "ctx0.png"} <= set(os.listdir(out))
    got = [np.load(os.path.join(out, f"ctx0_sample{i}.npy")) for i in range(2)]
    assert got[0].shape == (1, 2, 32, 32, 1) and not np.array_equal(got[0], got[1])

    # member i of context c draws from SeedSequence([seed, c * 997 + i]), pinned here
    assert step_generator(0, 998, "cpu").initial_seed() == 6017280483961462247
    args = sample_prediff.parse_args(argv)
    cfg = load_config(prediff_default_config, TINY)
    batch = torch.from_numpy(next(sample_prediff.data_module(cfg, args).test_batches()))
    y, x = batch[:, :3], batch[:, 3:5]
    ld = sample_prediff.build_sampler(cfg, args, "cpu")
    for i in range(2):
        want = ld.sample(y, use_alignment=True, alignment_kwargs=get_alignment_kwargs_avg_x(x),
                         sampler="ddim", ddim_steps=2, guidance_every_k=1,
                         generator=step_generator(0, i, "cpu"))
        assert np.array_equal(got[i], want.numpy())


def _template(model, *shapes):
    """The flax parameter tree's shapes as zeros (``jax.eval_shape``: no compile)."""
    args = [np.zeros(s, np.int32 if len(s) == 1 else np.float32) for s in shapes]
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)["params"]
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)


def test_converter_matches_the_jax_converter_and_round_trips(tmp_path):
    from prediff_tpu import factory as jf
    from prediff_tpu.config import load_config as jload
    from prediff_tpu.config import prediff_default_config as jdefault
    from prediff_tpu.utils.checkpoint import load_pretrained_torch, save_params_npz

    cfg, jcfg = load_config(prediff_default_config, TINY), jload(jdefault, TINY)
    d, a = cfg.model.diffusion, cfg.model.align.model_args
    models = {  # name -> (port model, JAX parameter template)
        "vae": (build_vae(cfg), _template(jf.build_vae(jcfg), (1, 32, 32, 1))),
        "earthformerunet": (build_unet(cfg), _template(
            jf.build_unet(jcfg), (1,) + tuple(d.latent_shape), (1,),
            (1,) + tuple(d.latent_cond_shape))),
        "alignment": (build_alignment_model(cfg), _template(
            jf.build_alignment_model(jcfg), (1,) + tuple(a.input_shape), (1,)))}
    gen = torch.Generator().manual_seed(5)
    pt, jax_out = tmp_path / "pt", tmp_path / "jax"
    pt.mkdir()
    jax_out.mkdir()
    state = {}
    for name, (model, template) in models.items():
        state[name] = init_params_(model, gen, randomize=True).state_dict()
        path = str(pt / PRETRAINED_NAMES[name])
        torch.save(state[name], path)
        save_params_npz(str(jax_out / f"{name}.npz"), load_pretrained_torch(path, template))
    written = convert_pretrained.convert(str(pt), str(tmp_path / "port"), cfg=cfg)
    assert sorted(written) == sorted(models)
    for name, (model, _) in models.items():
        with np.load(written[name]) as got, np.load(str(jax_out / f"{name}.npz")) as want:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        back = flax_params_to_torch(model, load_flax_npz(written[name]))
        assert back.keys() == state[name].keys()
        assert all(torch.equal(back[k], v) for k, v in state[name].items())


def test_downsample_matches_the_jax_loader(tmp_path):
    from prediff_tpu.datasets import SEVIRDataLoader as JaxLoader

    src = str(tmp_path / "sevir")
    make_synthetic_sevir_lr(src, num_events=2, H=24, W=24, T=49)
    assert downsample_sevir.main(["--sevir-dir", src, "--out", str(tmp_path / "port")]) == 0
    JaxLoader(data_types=["vil"], seq_len=49, raw_seq_len=49, stride=12,
              sevir_catalog=os.path.join(src, "CATALOG.csv"),
              sevir_data_dir=os.path.join(src, "data")).save_downsampled_dataset(
        str(tmp_path / "jax" / "data"), downsample_dict={"vil": (2, 3, 3)}, verbose=False)
    files = sorted(os.listdir(tmp_path / "port" / "data" / "vil" / "2019"))
    assert files == sorted(os.listdir(tmp_path / "jax" / "data" / "vil" / "2019")) and files
    for f in files:
        with h5py.File(tmp_path / "port" / "data" / "vil" / "2019" / f) as p, \
                h5py.File(tmp_path / "jax" / "data" / "vil" / "2019" / f) as j:
            assert p["vil"].shape == j["vil"].shape == (2, 8, 8, 25)
            assert np.array_equal(p["vil"][...], j["vil"][...])
    assert os.path.exists(tmp_path / "port" / "CATALOG.csv")


def test_refusals(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):   # no --device: the card, no fallback
        sample_prediff.main(["--out", str(tmp_path / "a"), "--cfg", TINY, "--synthetic"])
    # training takes --multihost (no cluster named: one process) and --nodes, and goes on
    # to the data, which is missing here (two ranks in tests/test_torch_ddp_training.py)
    with pytest.raises(ValueError, match="--sevir-dir"):
        train_sevirlr_prediff.main(["--save", str(tmp_path / "b"), "--multihost",
                                    "--device", "cpu"])
    with pytest.raises(ValueError, match="--sevir-dir"):
        train_sevirlr_prediff.main(["--save", str(tmp_path / "b"), "--nodes", "2",
                                    "--device", "cpu"])
    for main, argv in ((sample_prediff.main, ["--out", str(tmp_path / "c")]),
                       (train_sevirlr_prediff.main, ["--save", str(tmp_path / "d")])):
        with pytest.raises(ValueError, match="--sevir-dir"):
            main(argv + ["--cfg", TINY, "--device", "cpu"])


BLOCKED_IMPORTS = """
import importlib, os, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "prediff_tpu"):
    sys.modules[name] = None
import prediff_torch
names = [m.name for m in pkgutil.walk_packages(prediff_torch.__path__, "prediff_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(len(names), len([n for n in names if n.startswith("prediff_torch.cli.")]))
"""


def test_no_module_of_the_port_imports_jax():
    """Every module of ``prediff_torch`` (the programs too) and
    ``chip_smoke.py`` import with JAX, flax and the JAX package blocked, and
    no import line of theirs names them."""
    res = subprocess.run([sys.executable, "-c", BLOCKED_IMPORTS], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr[-3000:]
    n_all, n_cli = map(int, res.stdout.split())
    assert n_cli == 9 and n_all > 60
    sources = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(root, f) for root, _, fs in os.walk(os.path.join(REPO, "prediff_torch"))
        for f in fs if f.endswith(".py")]
    for path in sources:
        with open(path) as f:
            for line in f:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    assert words[1].split(".")[0] not in ("jax", "flax", "prediff_tpu"), \
                        (path, line)
