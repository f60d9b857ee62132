"""The port's deployment files: requirements-torch.txt, Dockerfile.cuda and
docker-compose.cuda.yml.

- Every module that ``highresnet_tpu_torch/**/*.py`` or ``chip_smoke.py``
  imports, at any depth of the file, is the standard library, the port
  itself, or a distribution that requirements-torch.txt names (required, or
  optional with a note); no JAX distribution is named.
- requirements.txt points GPU hosts to it.
- Dockerfile.cuda starts from a CUDA devel image named by tag, installs the
  file, copies the port with its CUDA sources and the configs, names no
  module of the JAX package, and runs the clearance precompute, then
  training.
- docker-compose.cuda.yml has docker-compose.yml's services, each with the
  JAX service's command on the port's module, volumes and ports, built from
  Dockerfile.cuda; the train service reserves NVIDIA GPUs.

Neither image can be built by the tests: building needs the network.
"""

import ast
import re
import sys
from pathlib import Path

import pytest
import yaml

REPO = Path(__file__).resolve().parents[1]
PORT = "highresnet_tpu_torch"
# import name -> distribution name, where they differ
DISTRIBUTIONS = {"PIL": "pillow", "cv2": "opencv-python-headless", "sklearn": "scikit-learn"}
OPTIONAL = {"scikit-learn", "matplotlib", "PyQt5"}
JAX_DISTRIBUTIONS = ("jax", "jaxlib", "flax", "optax", "orbax", "orbax-checkpoint", "chex")
# name, extras, version specifier, comment
REQUIREMENT = re.compile(
    r"^([A-Za-z0-9][A-Za-z0-9._-]*)(\[[^\]]*\])?\s*([<>=!~][^#\s]*)?\s*(#.*)?$")


def _requirements():
    """requirements-torch.txt as ({required name}, {optional name: note})."""
    required, optional = set(), {}
    for line in (REPO / "requirements-torch.txt").read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            m = REQUIREMENT.match(line.lstrip("#").strip())
            if m and m.group(4):  # "# name  # what needs it": an optional extra
                optional[m.group(1)] = m.group(4).lstrip("#").strip()
            continue
        m = REQUIREMENT.match(line)
        assert m, f"requirements-torch.txt: cannot parse {line!r}"
        required.add(m.group(1))
    return required, optional


def _imports(path):
    """The top-level names of every absolute import in ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted((REPO / PORT).rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_requirements_name_every_third_party_import():
    required, optional = _requirements()
    listed = required | set(optional)
    missing = {}
    for path in SOURCES:
        for name in _imports(path):
            if name in sys.stdlib_module_names or name == PORT:
                continue
            if DISTRIBUTIONS.get(name, name) not in listed:
                missing.setdefault(name, []).append(str(path.relative_to(REPO)))
    assert not missing, f"imported but not in requirements-torch.txt: {missing}"
    for name in ("torch", "numpy", "scipy", "pillow", "opencv-python-headless", "pandas",
                 "tensorboardX"):
        assert name in required, name


def test_requirements_optional_extras_carry_their_note():
    required, optional = _requirements()
    assert set(optional) == OPTIONAL
    assert not OPTIONAL & required
    assert all(optional.values()), optional


def test_requirements_name_no_jax():
    required, optional = _requirements()
    names = {n.lower() for n in required | set(optional)}
    assert not names & set(JAX_DISTRIBUTIONS), names & set(JAX_DISTRIBUTIONS)
    text = (REPO / "requirements-torch.txt").read_text()
    body = [line for line in text.splitlines() if line.strip() and not line.startswith("#")]
    assert not [line for line in body if re.search(r"\b(jax|flax|optax|orbax)", line)], body


def test_requirements_txt_points_to_the_port_file():
    lines = [line for line in (REPO / "requirements.txt").read_text().splitlines()
             if "requirements-torch.txt" in line]
    assert len(lines) == 1 and lines[0].startswith("#"), lines


def _dockerfile():
    return (REPO / "Dockerfile.cuda").read_text()


def _instructions(text):
    """Dockerfile instructions as (KEYWORD, argument), continuations joined."""
    joined = re.sub(r"\\\n", " ", text)
    out = []
    for line in joined.splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            keyword, _, arg = line.partition(" ")
            out.append((keyword.upper(), arg.strip()))
    return out


def test_dockerfile_cuda_builds_the_port_on_a_cuda_devel_image():
    steps = _instructions(_dockerfile())
    bases = [arg for kw, arg in steps if kw == "FROM"]
    base = r"nvidia/cuda:\d+\.\d+(\.\d+)?-[a-z-]*devel-[a-z0-9.]+"  # a tag, not "latest"
    assert len(bases) == 1 and re.fullmatch(base, bases[0]), bases
    runs = " ".join(arg for kw, arg in steps if kw == "RUN")
    assert "pip install --no-cache-dir -r requirements-torch.txt" in runs
    copies = [arg.split() for kw, arg in steps if kw == "COPY"]
    assert ["requirements-torch.txt", "."] in copies
    assert [f"{PORT}/", f"{PORT}/"] in copies  # the whole package, csrc/ included
    assert ["configs/", "configs/"] in copies
    assert sorted((REPO / PORT / "csrc").glob("*.cu"))
    ignore = REPO / ".dockerignore"
    assert not ignore.exists() or "csrc" not in ignore.read_text()
    cmd = [arg for kw, arg in steps if kw == "CMD"]
    assert len(cmd) == 1
    modules = re.findall(r"python -m ([\w.]+)", cmd[0])
    assert modules == [f"{PORT}.cli.save_clearance", f"{PORT}.cli.train"], modules


@pytest.mark.parametrize("name", ["Dockerfile.cuda", "docker-compose.cuda.yml"])
def test_cuda_files_name_only_the_port(name):
    text = (REPO / name).read_text()
    assert not re.search(r"\bhighresnet_tpu(?!_torch)\b", text)
    assert not re.search(r"\b(jax|flax|optax|orbax|libtpu)\b", text, re.IGNORECASE)
    assert PORT in text


def test_compose_cuda_mirrors_the_jax_services():
    jax = yaml.safe_load((REPO / "docker-compose.yml").read_text())["services"]
    cuda = yaml.safe_load((REPO / "docker-compose.cuda.yml").read_text())["services"]
    assert set(cuda) == set(jax) == {"save_clearance", "train", "tensorboard"}
    for name, service in cuda.items():
        want = jax[name]
        assert service["build"] == {"context": ".", "dockerfile": "Dockerfile.cuda"}, name
        assert service["command"] == want["command"].replace("highresnet_tpu.", f"{PORT}."), name
        assert service.get("volumes") == want.get("volumes"), name
        assert service.get("ports") == want.get("ports"), name
    devices = cuda["train"]["deploy"]["resources"]["reservations"]["devices"]
    assert [d["driver"] for d in devices] == ["nvidia"]
    assert all("gpu" in d["capabilities"] for d in devices)
    assert not any("deploy" in cuda[name] for name in ("save_clearance", "tensorboard"))
