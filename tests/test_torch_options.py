"""The port's option system against the JAX package's.

For the same argv, ``to_defectgan_config`` and ``to_train_config`` must
give the JAX package's configs field by field (exact equality), except
``use_pallas``: the port's CLIs route the AdaIN and SEAN norms through the
hand-written kernel (it runs for CUDA tensors only), where the JAX CLIs
leave Pallas off. Auto-incremented names, the ``opt.json`` snapshot and
its reload by ``--continue_training`` and ``--load_from_opt_file`` behave
as the JAX package's do.
"""
import dataclasses
import json

import pytest

from de_i2i_gan_tpu.config import options as joptions
from de_i2i_gan_torch.config import options

# (flags of both parsers, flags of the train parser only)
ARGVS = {
    "defaults": ([], []),
    "adain_256": (["--style_norm_block_type", "adain", "--image_size", "256",
                   "--batch_size", "8", "--diff_aug", "color,cutout"],
                  ["--lr", "2e-4", "1e-4", "--num_epochs", "3"]),
    "sean_all": (["--style_norm_block_type", "sean", "--use_running_stats",
                  "--style_distill", "--sean_alpha", "0.5", "--embed_nc", "24",
                  "--num_embeds", "3", "--use_spectral", "--add_noise",
                  "--cycle_gan", "--skip_conn", "--compute_dtype", "float32",
                  "--loss_weight", "1", "2", "3", "4", "5"],
                 ["--optimizer", "rmsprop", "--scheduler", "cos",
                  "--ema_decay", "0.999", "--num_critics", "3"]),
    "tiny": (["--image_size", "32", "--label_nc", "4", "--batch_size", "2",
              "--ngf", "8", "--ndf", "8", "--num_res", "2", "--hidden_nc",
              "16", "--num_layers", "2", "--latent_dim", "8", "--ndf", "16"],
             []),
}


def _parse(module, kind, argv, ckpt_dir):
    return module.Options(kind).parse(argv + ["--ckpt_dir", str(ckpt_dir)])


@pytest.mark.parametrize("kind", ["defectgan_train", "defectgan_test"])
@pytest.mark.parametrize("argv", sorted(ARGVS))
def test_configs_match_jax_field_by_field(kind, argv, tmp_path):
    both, train_only = ARGVS[argv]
    argv = both + (train_only if kind.endswith("train") else [])
    opt = _parse(options, kind, argv, tmp_path / "torch")
    jopt = _parse(joptions, kind, argv, tmp_path / "jax")
    assert vars(opt).keys() <= vars(jopt).keys()
    cfg = dataclasses.asdict(options.to_defectgan_config(opt))
    jcfg = dataclasses.asdict(joptions.to_defectgan_config(jopt))
    assert cfg.pop("use_pallas") is True and jcfg.pop("use_pallas") is False
    assert cfg == jcfg
    for clf in ("bce", "cce"):
        assert (dataclasses.asdict(options.to_train_config(opt, clf)) ==
                dataclasses.asdict(joptions.to_train_config(jopt, clf)))


def test_names_auto_increment_as_in_jax(tmp_path):
    names = {}
    for module, sub in ((options, "torch"), (joptions, "jax")):
        names[sub] = [_parse(module, "defectgan_train", [], tmp_path / sub).name
                      for _ in range(3)]
    assert names["torch"] == names["jax"] == ["exp0", "exp1", "exp2"]
    assert (tmp_path / "torch" / "exp1" / "opt.json").exists()
    assert (tmp_path / "torch" / "exp1" / "opt.txt").exists()


def test_continue_training_reloads_the_snapshot(tmp_path):
    first = ["--name", "run", "--image_size", "48", "--style_norm_block_type",
             "adain", "--lr", "1e-3", "5e-4", "--num_epochs", "2"]
    resumed = ["--name", "run", "--continue_training", "--num_epochs", "3"]
    got = {}
    for module, sub in ((options, "torch"), (joptions, "jax")):
        _parse(module, "defectgan_train", first, tmp_path / sub)
        got[sub] = vars(_parse(module, "defectgan_train", resumed,
                               tmp_path / sub))
    opt = got["torch"]
    assert (opt["image_size"], opt["style_norm_block_type"], opt["lr"],
            opt["num_epochs"], opt["load_model_name"]) == (
        48, "adain", [1e-3, 5e-4], 3, "run")
    assert opt["continue_training"] is True
    assert {k: v for k, v in opt.items() if k != "ckpt_dir"} == {
        k: v for k, v in got["jax"].items() if k in opt and k != "ckpt_dir"}
    saved = json.loads((tmp_path / "torch" / "run" / "opt.json").read_text())
    assert saved["num_epochs"] == 3 and saved["image_size"] == 48


def test_load_from_opt_file_sets_defaults(tmp_path):
    _parse(options, "defectgan_train", ["--name", "src", "--ngf", "16"],
           tmp_path)
    path = tmp_path / "src" / "opt.json"
    # the snapshot of a resumed run: --load_from_opt_file starts afresh
    path.write_text(json.dumps({**json.loads(path.read_text()),
                                "continue_training": True}))
    opt = _parse(options, "defectgan_train",
                 ["--name", "new", "--load_from_opt_file", str(path),
                  "--ndf", "32"], tmp_path)
    assert (opt.name, opt.ngf, opt.ndf, opt.continue_training) == (
        "new", 16, 32, False)


def test_gpu_ids_pick_the_device(tmp_path):
    """One id, or the first of a list (what does not train data-parallel
    runs there, as JAX accepts the list and ignores it)."""
    for ids, device in (("-1", "cpu"), ("0", "cuda:0"), ("1", "cuda:1"),
                        ("0,1", "cuda:0"), ("3,1", "cuda:3"),
                        ("-1,0", "cpu")):
        opt = _parse(options, "defectgan_test", [f"--gpu_ids={ids}"],
                     tmp_path)
        assert options.device_of(opt) == device
