"""CLI option system, counterpart of ``de_i2i_gan_tpu/config/options.py``
for DefectGAN training and testing.

The reference's flag surface (defectGAN/options/base_options.py:8-179,
train_options.py, test_options.py, defectgan_options.py) backed by the
config dataclasses:

  * hierarchical parsers with override-by-later-group (argparse
    conflict_handler='resolve')
  * auto-incrementing experiment names (exp -> exp0, exp1, ...)
  * options snapshot saved as opt.json + opt.txt; --continue_training /
    --load_from_opt_file reload it as new defaults
  * printed table of options that differ from defaults

``--gpu_ids`` picks the device as the reference does: ``-1`` is the CPU,
one id is that CUDA device, and of a list the first runs whatever does not
train data-parallel. The training kinds' ``--data_parallel``,
``--num_devices`` and ``--gpu_ids`` list spread a run over one process a
device (``parallel/mesh.py::mesh_from_flag``). ``to_defectgan_config``
routes the AdaIN and SEAN norms through the hand-written kernel
(``use_pallas=True``); the kernel runs for CUDA tensors only, the plain
version on the CPU. Every other field is the JAX package's.
``to_pix2pix_config`` builds the DefectGAN generator with SPADE, which runs
no kernel; the WGAN nets hold BatchNorm only. The ViT kinds (``vit_train``,
``vit_test``) take the frozen backbone's flags.
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

from de_i2i_gan_torch.config.defaults import (
    DefectGanConfig, MAEConfig, TrainConfig, WGanConfig)


# --------------------------------------------------------------- arg groups
def add_base_args(p: argparse.ArgumentParser):
    p.add_argument("--name", type=str, default="exp",
                   help="experiment name; decides ckpt/log/result locations")
    p.add_argument("--model", type=str, default="defectgan",
                   help="which model to use [defectgan|wgan|pix2pix]")
    p.add_argument("--ckpt_dir", type=Path, default=Path("./ckpt"))
    p.add_argument("--log_dir", type=Path, default=Path("./logs"))
    p.add_argument("--phase", type=str, default="train",
                   help="train, val, test")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--input_nc", type=int, default=3)
    p.add_argument("--output_nc", type=int, default=3)
    p.add_argument("--data_dir", type=Path, default=Path("./data"))
    p.add_argument("--dataset_name", type=str, default="codebrim")
    p.add_argument("--dataset_data_type", type=str, default=None)
    p.add_argument("--load_from_opt_file", type=Path, default=None)
    p.add_argument("--init_type", type=str, default="normal",
                   help="[normal|xavier|kaiming|orthogonal]")
    p.add_argument("--init_variance", type=float, default=0.02)
    p.add_argument("--use_spectral", action="store_true")
    p.add_argument("--load_model_name", type=str, default=None)
    p.add_argument("--which_epoch", type=str, default="latest")
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--ndf", type=int, default=64)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   help="[bfloat16|float32] on-device compute precision")
    p.add_argument("--gpu_ids", type=str, default="0",
                   help="CUDA device ids (a list: one rank each), or -1 for "
                        "the CPU (base_options.py:19)")
    p.add_argument("--num_devices", type=int, default=None,
                   help="devices to shard the batch over (default: all; "
                        "with --gpu_ids -1, CPU ranks)")
    return p


def add_train_args(p: argparse.ArgumentParser):
    p.add_argument("--continue_training", action="store_true")
    p.add_argument("--optimizer", type=str, default="adam",
                   help="[sgd|rmsprop|adam|adamw]")
    p.add_argument("--num_epochs", type=int, default=-1)
    p.add_argument("--num_iters", type=int, default=500_000)
    p.add_argument("--lr", type=float, nargs="+", default=[2e-4],
                   help="[lr] or [lr_d, lr_g] (TTUR)")
    p.add_argument("--lr_decay", type=float, default=5e-3)
    p.add_argument("--scheduler", type=str, default="step",
                   help="[step|exp|cos]")
    p.add_argument("--num_critics", type=int, default=5)
    p.add_argument("--save_latest_freq", type=int, default=1000)
    p.add_argument("--save_ckpt_freq", type=int, default=4)
    p.add_argument("--save_img_freq", type=int, default=4)
    p.add_argument("--num_display_images", type=int, default=8)
    p.add_argument("--ema_decay", type=float, default=0.0)
    p.add_argument("--val_metrics", type=str, nargs="+", default=None,
                   help="in-training validation metrics [fid|is|lpips], "
                        "every save_ckpt_freq epochs")
    p.add_argument("--native_loader", action="store_true",
                   help="the C++ input pipeline (runtime/dataloader.cc): u8 "
                        "super-batches, cached under --native_cache_dir")
    p.add_argument("--native_cache_dir", type=Path, default=None)
    p.add_argument("--data_parallel", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="shard the batch over the visible devices, one "
                        "process each ('auto': when more than one is "
                        "visible and the batch divides them)")
    return p


def add_test_args(p: argparse.ArgumentParser):
    p.add_argument("--results_dir", type=Path, default=Path("./results"))
    p.set_defaults(phase="test")
    p.add_argument("--metrics", type=str, nargs="+", default=None,
                   help="[fid|is|lpips]")
    p.add_argument("--cal_mfid", action="store_true")
    p.add_argument("--save_img_grid", action="store_true")
    p.add_argument("--save_img", action="store_true")
    p.add_argument("--save_stats", action="store_true")
    p.add_argument("--cal_clf", action="store_true")
    p.add_argument("--vis_style_embeds", type=str, default=None)
    p.add_argument("--metrics_out", type=Path, default=None)
    p.add_argument("--save_diverse_images", action="store_true")
    p.add_argument("--num_display_images", type=int, default=8)
    return p


def add_defectgan_args(p: argparse.ArgumentParser):
    p.add_argument("--label_nc", type=int, default=6)
    p.add_argument("--num_scales", type=int, default=2)
    p.add_argument("--num_res", type=int, default=6)
    p.add_argument("--add_noise", action="store_true")
    p.add_argument("--style_norm_block_type", type=str, default="spade",
                   help="[spade|sean|adain]")
    p.add_argument("--hidden_nc", type=int, default=128)
    p.add_argument("--num_layers", type=int, default=5)
    p.add_argument("--cycle_gan", action="store_true")
    p.add_argument("--skip_conn", action="store_true")
    p.add_argument("--dims", type=int, default=2048,
                   help="Inception feature dims for FID")
    p.add_argument("--num_imgs", type=int, default=5000)
    p.add_argument("--npz_path", type=str, default=None)
    p.add_argument("--npy_path", type=str, default=None)
    p.add_argument("--num_lpips_images", type=int, default=10)
    p.add_argument("--embed_nc", type=int, default=768)
    p.add_argument("--latent_dim", type=int, default=16)
    p.add_argument("--embed_path", type=Path, default=None)
    p.add_argument("--num_embeds", type=int, default=5)
    p.add_argument("--sean_alpha", type=float, default=None)
    p.add_argument("--style_distill", action="store_true")
    p.add_argument("--use_running_stats", action="store_true")
    p.add_argument("--loss_weight", type=float, nargs="+",
                   default=[2, 5, 5, 5, 1],
                   help="[clf_d, clf_g, rec, sd_cyc, sd_con]")
    p.add_argument("--diff_aug", type=str, default="",
                   help="comma-separated DiffAugment policy")
    return p


def add_mae_args(p: argparse.ArgumentParser):
    p.set_defaults(batch_size=32, optimizer="adamw", num_epochs=200,
                   lr=[1.5e-4], scheduler="cos", lr_decay=0.05,
                   loss_weight=[10, 3, 1], num_critics=1,
                   save_latest_freq=300, num_display_images=4,
                   save_img_freq=1)
    p.add_argument("--mask_ratio", type=float, default=0.75)
    p.add_argument("--patch_size", type=int, default=8)
    p.add_argument("--mask_token_type", type=str, default="position",
                   help="[zero|mean|scalar|vector|position|full]")
    p.add_argument("--split_training", action="store_true")
    return p


def add_wgan_args(p: argparse.ArgumentParser):
    p.set_defaults(model="wgan", dataset_name="face", batch_size=128,
                   image_size=64, optimizer="rmsprop", num_epochs=120,
                   lr=[5e-5], num_critics=5)
    p.add_argument("--noise_dim", type=int, default=100)
    p.add_argument("--clipping_limit", type=float, default=0.03)
    return p


def add_pix2pix_args(p: argparse.ArgumentParser):
    """The pix2pix/pix2pixHD flag surface (--dataroot --load_size
    --crop_size --lambda_L1 --netG --netD ...)."""
    p.set_defaults(model="pix2pix", image_size=256, batch_size=1,
                   num_critics=1, lr=[2e-4], dataset_name="aligned",
                   num_epochs=200, num_iters=-1, ema_decay=0.999,
                   label_nc=2)
    p.add_argument("--dataroot", type=Path, default=None,
                   help="folder with <phase>/ aligned A|B images; "
                        "'synthetic' for the procedural paired dataset")
    p.add_argument("--direction", type=str, default="AtoB",
                   help="[AtoB|BtoA]")
    p.add_argument("--load_size", type=int, default=286,
                   help="scale images to this size before cropping")
    p.add_argument("--crop_size", type=int, default=256,
                   help="final (train) crop fed to the nets")
    p.add_argument("--no_flip", action="store_true")
    p.add_argument("--lambda_L1", type=float, default=100.0)
    p.add_argument("--lambda_feat", type=float, default=10.0,
                   help="multi-scale feature-matching weight (pix2pixHD)")
    p.add_argument("--gan_mode", type=str, default="lsgan",
                   help="[lsgan|hinge]")
    p.add_argument("--netG", type=str, default="resnet",
                   help="[resnet|unet] generator backbone")
    p.add_argument("--netD", type=str, default="multiscale",
                   help="[basic|multiscale] discriminator")
    p.add_argument("--num_D", type=int, default=2,
                   help="discriminator pyramid scales (netD=multiscale)")
    p.add_argument("--n_layers_D", type=int, default=3)
    p.add_argument("--iters_per_launch", type=int, default=4,
                   help="iterations a super-step")
    p.add_argument("--max_dataset_size", type=int, default=0,
                   help="cap the train set size (0 = unlimited)")
    p.add_argument("--fused_prop", action="store_true",
                   help="FusedProp: one G forward, both updates from the "
                        "pre-update nets (arxiv 2004.03335)")
    return p


def add_vit_args(p: argparse.ArgumentParser):
    p.set_defaults(model="vit", image_size=224, optimizer="adamw",
                   scheduler="cos", num_epochs=20, lr=[1e-4])
    p.add_argument("--model_size", type=str, default="base",
                   help="[base|large]")
    p.add_argument("--vit_path", type=str, default=None,
                   help="local HF ViT directory or weight file (frozen "
                        "backbone); drawn from --seed when omitted")
    return p


def add_vit_test_args(p: argparse.ArgumentParser):
    """ViT test flags (reference: options/vit_options.py:57-77)."""
    p.add_argument("--save_embeddings", action="store_true")
    p.add_argument("--visualize_tsne", action="store_true")
    p.add_argument("--calc_classifier_acc", action="store_true")
    p.add_argument("--data_type", type=str, default="fusion",
                   help="[defects|background|fusion]")
    p.add_argument("--num_embeddings_epochs", type=int, default=1)
    return p


# ------------------------------------------------------------------ Options
class Options:
    """parse/save/reload mirroring BaseOptions semantics."""

    GROUPS = {
        "defectgan_train": (add_base_args, add_defectgan_args, add_train_args),
        "defectgan_test": (add_base_args, add_defectgan_args, add_test_args),
        "mae_train": (add_base_args, add_defectgan_args, add_train_args,
                      add_mae_args),
        "mae_test": (add_base_args, add_defectgan_args, add_test_args,
                     add_mae_args),
        "wgan_train": (add_base_args, add_train_args, add_wgan_args),
        "wgan_test": (add_base_args, add_test_args, add_wgan_args),
        "vit_train": (add_base_args, add_train_args, add_vit_args),
        "vit_test": (add_base_args, add_test_args, add_vit_args,
                     add_vit_test_args),
        "pix2pix_train": (add_base_args, add_defectgan_args, add_train_args,
                          add_pix2pix_args),
        "pix2pix_test": (add_base_args, add_defectgan_args, add_test_args,
                         add_pix2pix_args),
    }

    def __init__(self, kind: str):
        self.kind = kind
        self.is_train = kind.endswith("train")
        self.parser = argparse.ArgumentParser(
            conflict_handler="resolve",
            formatter_class=argparse.ArgumentDefaultsHelpFormatter)
        for add in self.GROUPS[kind]:
            add(self.parser)

    # -- reference gather_options flow (base_options.py:58-102)
    def parse(self, argv=None, save: bool = True) -> argparse.Namespace:
        opt, _ = self.parser.parse_known_args(argv)
        if opt.name == self.parser.get_default("name"):
            idx = 0
            while (Path(opt.ckpt_dir) / f"{opt.name}{idx}").exists():
                idx += 1
            self.parser.set_defaults(name=f"{opt.name}{idx}")
        if not self.is_train or getattr(opt, "continue_training", False):
            self.parser.set_defaults(load_model_name=opt.name)
        if opt.load_from_opt_file or getattr(opt, "continue_training", False):
            self._update_defaults_from_file(opt)
            if opt.load_from_opt_file:
                self.parser.set_defaults(continue_training=False)
        opt = self.parser.parse_args(argv)
        opt.is_train = self.is_train
        self.print_options(opt)
        if self.is_train and save:
            self.save_options(opt)
        return opt

    def print_options(self, opt):
        lines = ["----------------- Options ---------------"]
        for k, v in sorted(vars(opt).items()):
            default = self.parser.get_default(k)
            mark = f"\t[default: {default}]" if v != default else ""
            lines.append(f"{k:>25}: {str(v):<30}{mark}")
        lines.append("----------------- End -------------------")
        print("\n".join(lines))

    def _opt_path(self, opt) -> Path:
        d = Path(opt.ckpt_dir) / opt.name
        d.mkdir(parents=True, exist_ok=True)
        return d / "opt.json"

    def save_options(self, opt):
        path = self._opt_path(opt)
        payload = {k: (str(v) if isinstance(v, Path) else v)
                   for k, v in vars(opt).items()}
        path.write_text(json.dumps(payload, indent=1))
        with path.with_suffix(".txt").open("w") as f:
            for k, v in sorted(vars(opt).items()):
                f.write(f"{k:>25}: {v}\n")

    def _update_defaults_from_file(self, opt):
        if getattr(opt, "continue_training", False):
            path = self._opt_path(opt)
        else:
            path = Path(opt.load_from_opt_file)
        old = json.loads(path.read_text())
        for k, v in old.items():
            if k in ("name", "load_model_name", "is_train"):
                continue
            if self.parser.get_default(k) is not None or k in vars(opt):
                cur = self.parser.get_default(k)
                # a path saved as None stays None (the JAX package's
                # Path(None) makes --load_from_opt_file raise)
                if v is not None and (isinstance(cur, Path) or
                                      isinstance(vars(opt).get(k), Path)):
                    v = Path(v)
                self.parser.set_defaults(**{k: v})


# ----------------------------------------------------------------- the device
def device_of(opt) -> str:
    """``--gpu_ids -1`` -> the CPU; a device id -> that CUDA device; of a
    list, the first (JAX accepts a list and ignores it where it takes no
    mesh: the test CLIs, ``train_vit``)."""
    gid = int(str(opt.gpu_ids).split(",")[0])
    return "cpu" if gid < 0 else f"cuda:{gid}"


def parse_for_ranks(kind: str, argv=None):
    """``Options(kind).parse(argv)`` for a training CLI that may run as one
    rank of several: only rank 0 writes ``opt.json``, and
    ``parallel/mesh.py::run`` hands every rank rank 0's options."""
    import os

    from de_i2i_gan_torch.parallel import distributed
    rank = int(os.environ.get("RANK", distributed.rank()))
    return Options(kind).parse(argv, save=rank == 0)


# ------------------------------------------------------- namespace -> configs
def to_defectgan_config(opt) -> DefectGanConfig:
    return DefectGanConfig(
        image_size=opt.image_size, input_nc=opt.input_nc,
        output_nc=opt.output_nc, label_nc=opt.label_nc, ngf=opt.ngf,
        num_scales=opt.num_scales, num_res=opt.num_res,
        add_noise=opt.add_noise,
        style_norm_block_type=opt.style_norm_block_type,
        hidden_nc=opt.hidden_nc, ndf=opt.ndf, num_layers=opt.num_layers,
        init_type=opt.init_type, init_variance=opt.init_variance,
        cycle_gan=opt.cycle_gan, skip_conn=opt.skip_conn,
        use_spectral=opt.use_spectral, embed_nc=opt.embed_nc,
        latent_dim=opt.latent_dim, num_embeds=opt.num_embeds,
        sean_alpha=opt.sean_alpha, style_distill=opt.style_distill,
        use_running_stats=opt.use_running_stats,
        compute_dtype=opt.compute_dtype, use_pallas=True)


def to_train_config(opt, clf_loss_type: str = "bce") -> TrainConfig:
    # test-phase parsers omit the train group; fall back to TrainConfig
    # defaults there (the steps still need a TrainConfig)
    d = TrainConfig()
    return TrainConfig(
        batch_size=opt.batch_size,
        optimizer=getattr(opt, "optimizer", d.optimizer),
        lr=tuple(getattr(opt, "lr", d.lr)),
        lr_decay=getattr(opt, "lr_decay", d.lr_decay),
        scheduler=getattr(opt, "scheduler", d.scheduler),
        num_epochs=getattr(opt, "num_epochs", d.num_epochs),
        num_iters=getattr(opt, "num_iters", d.num_iters),
        num_critics=getattr(opt, "num_critics", d.num_critics),
        loss_weight=tuple(getattr(opt, "loss_weight", (2, 5, 5, 5, 1))),
        diff_aug=getattr(opt, "diff_aug", ""), clf_loss_type=clf_loss_type,
        ema_decay=getattr(opt, "ema_decay", 0.0))


def to_pix2pix_config(opt) -> DefectGanConfig:
    """crop_size is the model's working resolution; netG unet -> skip_conn;
    cycle_gan=True returns the raw tanh output (full-image synthesis, no
    defect-overlay composition for paired translation). SPADE, always: the
    generator runs no kernel."""
    return DefectGanConfig(
        image_size=opt.crop_size, input_nc=opt.input_nc,
        output_nc=opt.output_nc, label_nc=opt.label_nc, ngf=opt.ngf,
        num_scales=opt.num_scales, num_res=opt.num_res,
        add_noise=opt.add_noise, style_norm_block_type="spade",
        hidden_nc=opt.hidden_nc, ndf=opt.ndf, num_layers=opt.num_layers,
        cycle_gan=True, skip_conn=(opt.netG == "unet"),
        use_spectral=opt.use_spectral, compute_dtype=opt.compute_dtype)


def to_wgan_config(opt) -> WGanConfig:
    return WGanConfig(image_size=opt.image_size, noise_dim=opt.noise_dim,
                      ngf=opt.ngf, ndf=opt.ndf,
                      num_layers=int(math.log2(opt.image_size)) - 3,
                      clipping_limit=opt.clipping_limit,
                      num_critics=opt.num_critics,
                      compute_dtype=opt.compute_dtype)


def to_mae_config(opt) -> MAEConfig:
    return MAEConfig(mask_ratio=opt.mask_ratio, patch_size=opt.patch_size,
                     mask_token_type=opt.mask_token_type,
                     split_training=opt.split_training)
