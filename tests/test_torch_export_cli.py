"""``cli/export_model.py`` on the CPU: both ``--model``s export from
checkpoints written by the port's ``save_checkpoint`` (weights drawn from
another seed than the CLI's own init, so a checkpoint that did not load
shows), ``--validate`` holds each artifact against the live forward
within 2e-5, and the artifacts compute what the saved nets compute.
``--platforms`` takes cpu and cuda only (``tpu`` raises). Tiny config,
float32.
"""
import pytest
import torch

from de_i2i_gan_torch.cli import export_model
from de_i2i_gan_torch.config.options import (
    Options, to_defectgan_config, to_train_config)
from de_i2i_gan_torch.serving import (
    defectgan_example_args, defectgan_serving_module, load_exported)
from de_i2i_gan_torch.train.checkpoint import save_checkpoint
from de_i2i_gan_torch.train.jax_import import (
    init_starganv2_weights, init_weights)
from de_i2i_gan_torch.train.solver import StarGANv2Config, StarGANv2Solver
from de_i2i_gan_torch.train.steps import DefectGanSteps

torch.set_num_threads(1)

TOL = 2e-5


def _dg_argv(tmp_path, style):
    return ["--name", "dg", "--ckpt_dir", str(tmp_path / "ckpt"),
            "--image_size", "32", "--label_nc", "4", "--ngf", "8", "--ndf",
            "8", "--num_res", "2", "--hidden_nc", "16", "--num_layers", "2",
            "--embed_nc", "12", "--num_embeds", "2", "--gpu_ids", "-1",
            "--compute_dtype", "float32", "--style_norm_block_type", style]


@pytest.mark.parametrize("style", ["adain", "sean", "spade"])
def test_export_defectgan_validates(style, tmp_path):
    argv = _dg_argv(tmp_path, style)
    opt = Options("defectgan_test").parse(argv, save=False)
    steps = DefectGanSteps(to_defectgan_config(opt), to_train_config(opt),
                           device="cpu")
    init_weights(steps, 99)
    save_checkpoint(tmp_path / "ckpt", "dg", "latest", steps)
    out = tmp_path / "dg.pt2"
    written = export_model.main(["--model", "defectgan", "--validate",
                                 "--out", str(out)] + argv)
    assert list(written) == ["cpu"] and written["cpu"]["path"] == out
    assert written["cpu"]["validate"]["max_abs"] <= TOL
    args = defectgan_example_args(
        steps, 2, 5, torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = load_exported(out).module()(*args)
        want = defectgan_serving_module(steps)(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


SGV2 = ["--img_size", "64", "--num_domains", "3", "--latent_dim", "4",
        "--style_dim", "8", "--hidden_nc", "16", "--embed_nc", "12",
        "--num_embeds", "2", "--max_conv_dim", "64"]


@pytest.mark.parametrize("norm", ["adain", "sean"])
def test_export_starganv2_validates(norm, tmp_path):
    cfg = StarGANv2Config(img_size=64, num_domains=3, latent_dim=4,
                          style_dim=8, hidden_nc=16, embed_nc=12, num_embeds=2,
                          max_conv_dim=64, w_hpf=0.0, norm_type=norm)
    solver = StarGANv2Solver(cfg, device="cpu")
    init_starganv2_weights(solver, 5)
    save_checkpoint(tmp_path / "ckpt", "starganv2", "000002", solver)
    written = export_model.main(
        ["--model", "starganv2", "--checkpoint_dir", str(tmp_path / "ckpt"),
         "--resume_iter", "2", "--out_dir", str(tmp_path / "export"),
         "--validate", "--platforms", "cpu", "--norm_type", norm] + SGV2)
    paths = written["cpu"]["paths"]
    want = ["generator", "style_encoder", "mapping"] if norm == "adain" \
        else ["generator"]
    assert list(paths) == want
    assert all(p.parent == tmp_path / "export" and p.suffix == ".pt2"
               for p in paths.values())
    assert written["cpu"]["validate"]["max_abs"] <= TOL
    gen = torch.Generator().manual_seed(6)
    x = torch.rand(2, 64, 64, 3, generator=gen) * 2 - 1
    y = torch.tensor([2, 0])
    s = (torch.randn(2, 8, generator=gen) if norm == "adain"
         else torch.randn(2, 2, 12, generator=gen))
    with torch.no_grad():
        got = load_exported(paths["generator"]).module()(x, s, y)
    torch.testing.assert_close(got, solver.generate(x, s, y), atol=TOL,
                               rtol=TOL)
    if norm == "adain":
        z = torch.randn(2, 4, generator=gen)
        with torch.no_grad():
            torch.testing.assert_close(
                load_exported(paths["mapping"]).module()(z, y),
                solver.ema_M(z, y), atol=TOL, rtol=TOL)
            torch.testing.assert_close(
                load_exported(paths["style_encoder"]).module()(x, y),
                solver.ema_S(x, y), atol=TOL, rtol=TOL)


def test_platforms():
    with pytest.raises(ValueError, match="--platforms takes"):
        export_model.main(["--model", "starganv2", "--platforms", "tpu",
                           "--out_dir", "never"])
    assert export_model._devices(None, "cuda") == {"cuda": "cuda:0"}
    assert export_model._devices(["cpu", "cuda"], "cuda") == {
        "cpu": "cpu", "cuda": "cuda:0"}
    p = export_model.Path("out/gen.pt2")
    assert export_model._out_path(p, "cuda", True).name == "gen.cuda.pt2"
    assert export_model._out_path(p, "cpu", False) == p
