"""The port imports nothing of JAX or of the JAX package, nor the
``safetensors``, ``tokenizers``, ``transformers``, ``regex``, ``msgpack``,
``aiohttp``, ``yaml``, ``pydantic``, ``datasets`` and ``PIL`` packages (the
H100 host has none of them): every
module of ``pipelinerl_tpu_torch`` and ``chip_smoke`` imports in a process
that refuses all of them, and the port's tokenizer reads the committed
fixture there; every stage entrypoint, started as
``python -m pipelinerl_tpu_torch.entrypoints.<stage>``, imports its stage
without them, and the host-only stages (the actor, the preprocessor, the
environment servers and the stream hub) import no kernel; the image
pipeline, the visual processors and chartqa import no torch;
``chip_smoke.main`` raises where there is no CUDA card."""

import json
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

CHILD = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    REFUSED = ("jax", "jaxlib", "pipelinerl_tpu", "safetensors", "tokenizers", "transformers", "regex",
               "msgpack", "aiohttp", "yaml", "pydantic", "datasets", "PIL")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"the port must not import {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import pipelinerl_tpu_torch
    names = ["chip_smoke"]
    for m in pkgutil.walk_packages(pipelinerl_tpu_torch.__path__, "pipelinerl_tpu_torch."):
        names.append(m.name)
    for name in names:
        importlib.import_module(name)
    from pipelinerl_tpu_torch.models.hf_tokenizer import HFTokenizer
    tok = HFTokenizer("pipelinerl_tpu_torch/fixtures/hf_tokenizer")
    ids = tok.apply_chat_template([{"role": "user", "content": "say x"}], add_generation_prompt=True)
    assert tok.decode(ids) == "<|im_start|>user\\nsay x<|im_end|>\\n<|im_start|>assistant\\n"
    bad = [m for m in sys.modules if m.split(".")[0] in REFUSED]
    assert not bad, bad
    print("IMPORTED", len(names))
    import chip_smoke, torch
    if not torch.cuda.is_available():
        try:
            chip_smoke.main()
        except RuntimeError as e:
            print("RAISED", e)
    """
)


def test_port_imports_without_jax_and_chip_smoke_needs_a_card():
    proc = subprocess.run(
        [sys.executable, "-c", CHILD], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split("IMPORTED ")[1].split()[0])
    # every module of the package (serving, paged KV, training, processes
    # mode, the task domains and domain sampling, the environment servers,
    # the binary and TCP streams; the vision tower, mrope, the visual
    # processors and the image pipeline, vlm_bandit and chartqa; the memory
    # debugger, browse and gather_jsons), and chip_smoke
    assert n >= 111
    if not torch.cuda.is_available():
        assert "RAISED no CUDA device" in proc.stdout, proc.stdout
        assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    """Alone in a directory, the script cannot find the port and fails."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# installed as sitecustomize in a stage's child: refuse the packages, and at
# exit report what the stage imported (its main stops early on a missing
# config, after the stage module and its imports have loaded)
SITE = textwrap.dedent(
    """
    import atexit, sys

    REFUSED = ("jax", "jaxlib", "pipelinerl_tpu", "msgpack", "aiohttp", "yaml", "transformers", "tokenizers",
               "pydantic", "datasets", "PIL")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"the port must not import {name}")
            return None

    sys.meta_path.insert(0, Refuse())

    def report():
        mods = sorted(sys.modules)
        print("REFUSED_LOADED", [m for m in mods if m.split(".")[0] in REFUSED])
        print("KERNEL_MODULES", [m for m in mods if m.startswith("pipelinerl_tpu_torch.ops")])
        spec = getattr(sys.modules["__main__"], "__spec__", None)
        print("STAGE_LOADED", getattr(spec, "name", None))

    atexit.register(report)
    """
)
STAGES = {"run_device": True, "run_engine": True, "run_trainer": True, "run_actor": False, "run_preprocess": False,
          "run_environment": False, "run_stream_hub": False}


def test_stage_children_import_no_refused_package(tmp_path):
    (tmp_path / "sitecustomize.py").write_text(SITE)
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "PYTHONPATH": f"{tmp_path}:{ROOT}",
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    procs = {
        stage: subprocess.Popen(
            [sys.executable, "-m", f"pipelinerl_tpu_torch.entrypoints.{stage}", f"--config-dir={tmp_path}/none",
             "--config-name=exp_config", f"+me.kind={stage}"],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for stage in STAGES
    }
    try:
        outs = {stage: p.communicate(timeout=120) for stage, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    for stage, (out, err) in outs.items():
        assert "FileNotFoundError" in err and "exp_config.json" in err, (stage, err[-2000:])
        assert f"STAGE_LOADED pipelinerl_tpu_torch.entrypoints.{stage}" in out, (stage, out)
        assert "REFUSED_LOADED []" in out, (stage, out)
        if not STAGES[stage]:  # host-only stages load no model and no kernel
            assert "KERNEL_MODULES []" in out, (stage, out)


DOMAINS_CHILD = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    REFUSED = ("jax", "jaxlib", "pipelinerl_tpu", "aiohttp", "pydantic", "yaml", "datasets")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"the port must not import {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import pipelinerl_tpu_torch.domains as domains
    names = [m.name for m in pkgutil.walk_packages(domains.__path__, "pipelinerl_tpu_torch.domains.")]
    for name in names:
        importlib.import_module(name)
    heavy = [m for m in sys.modules if m.startswith(("pipelinerl_tpu_torch.ops", "pipelinerl_tpu_torch.models",
                                                     "pipelinerl_tpu_torch.inference.engine",
                                                     "pipelinerl_tpu_torch.train"))]
    print("DOMAINS", sorted(names))
    print("HEAVY", heavy)
    """
)


def test_domain_modules_import_no_model_or_kernel():
    """Every domain module (the actor's host-only code: tir, coding,
    deep_research and miniwob among them, and the environment servers)
    imports without jax, the JAX package, aiohttp, pydantic, yaml or
    datasets, and loads no model, no engine, no trainer and no kernel
    module."""
    proc = subprocess.run([sys.executable, "-c", DOMAINS_CHILD], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    for name in ("tir.sandbox", "tir.tool_parser", "tir.rollouts", "coding.verifier", "coding.dataset",
                 "coding.rollouts", "deep_research.environment", "deep_research.rollouts", "miniwob.simulated_env",
                 "miniwob.load_tasks", "miniwob.rollouts", "miniwob.environment_server", "math.verifier_api",
                 "logic.verifier_api", "servers"):
        assert f"pipelinerl_tpu_torch.domains.{name}" in proc.stdout, name
    assert "HEAVY []" in proc.stdout, proc.stdout


IMAGES_CHILD = textwrap.dedent(
    """
    import sys

    REFUSED = ("torch", "jax", "jaxlib", "pipelinerl_tpu", "PIL", "transformers")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"the image pipeline must not import {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import numpy as np
    from pipelinerl_tpu_torch.domains.chartqa.chartqa import multimodal_message
    from pipelinerl_tpu_torch.inference.image_pipeline import ImageProcessor
    from pipelinerl_tpu_torch.inference.processor import extract_images

    image = (np.arange(60 * 90 * 3) % 251).astype(np.uint8).reshape(60, 90, 3)
    (feats,) = extract_images([multimodal_message(image, "q")], ImageProcessor())
    print("FEATURES", list(feats["pixel_values"].shape), feats["image_grid_thw"])

    import json
    from pathlib import Path
    from pipelinerl_tpu_torch.inference import image_bmp, image_gif, image_lzw, image_tiff, image_webp
    from pipelinerl_tpu_torch.inference import image_ico, image_netpbm, image_pcx, image_qoi, image_sgi
    from pipelinerl_tpu_torch.inference import image_tga, image_xbm
    from pipelinerl_tpu_torch.inference.image_pipeline import decode_image
    from pipelinerl_tpu_torch.inference.processor import array_to_rgb

    class Raw:  # a PIL image's mode and samples, as the port sees one
        def __init__(self, array, mode, palette):
            self.array, self.mode, self.palette = array, mode, palette
            self.__array_interface__ = array.__array_interface__

        def getpalette(self):
            return self.palette

    images = Path("pipelinerl_tpu_torch/fixtures/images")
    palette = np.load(images / "raw_96x128_PA_palette.npy").tolist()
    for name in sorted(json.loads((images / "digests.json").read_text())):
        if name.endswith(".npy"):
            array, kind = np.load(images / name), name[len("raw_96x128_") : -len(".npy")]
            raw = array if kind.islower() else Raw(array, kind.replace("I16", "I;16"), palette)
            print("DECODED", name, list(array_to_rgb(raw).shape))
        else:
            print("DECODED", name, list(decode_image((images / name).read_bytes()).shape))
    """
)


def test_image_pipeline_imports_no_torch():
    """The host-only actor decodes and preprocesses images: the image
    pipeline, its GIF, BMP, TIFF, WebP, LZW, ICO, Netpbm, TGA, QOI, PCX,
    SGI, XBM and XPM decoders (each committed chart fixture decoded, each
    raw one through ``array_to_rgb``), the visual processors and chartqa
    run with torch, PIL and transformers refused."""
    proc = subprocess.run([sys.executable, "-c", IMAGES_CHILD], cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert "FEATURES [24, 1176] [1, 4, 6]" in proc.stdout, proc.stdout
    names = json.loads((ROOT / "pipelinerl_tpu_torch" / "fixtures" / "images" / "digests.json").read_text())
    assert len(names) >= 31
    for name in names:  # each decodes to the height and width its name gives
        shape = [*map(int, re.search(r"_(\d+)x(\d+)", name).groups()), 3]
        assert f"DECODED {name} {shape}" in proc.stdout, proc.stdout
