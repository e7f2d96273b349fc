"""Build and load the port's CUDA kernels (``csrc/*.cu``) with nvcc + ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``_build/<name>-<hash>.so`` (``_build`` is listed in ``.gitignore``)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The hash covers the source, every shared header in ``csrc/`` and the flags,
so an edited kernel is rebuilt and a stale library is never loaded.  The
build happens at first use; :func:`build` starts one nvcc per source, all
at once, and waits for them.  A failed or missing compiler raises.  ptxas
reports each kernel's registers and spills (``-Xptxas -v``); the report is
kept beside the library as ``<name>-<hash>.log`` and read by
:func:`resource_usage`.

Every C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()`` as an int;
:func:`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: the kernel sources, one shared library each
KERNELS = ("conv2d", "transposed_conv", "matmul", "flash_attention")

FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")
#: ask ptxas for each kernel's registers, stack and spills
PTXAS_REPORT = ("-Xptxas", "-v")

_NVCC_TIMEOUT_S = 600

#: loaded libraries of this process, by kernel name
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or the
    toolkit's default install.  Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from csrc/ at first "
                       "use")


def nvcc_command(nvcc: str, src: Path, out: Path) -> list[str]:
    return [nvcc, *FLAGS, *PTXAS_REPORT, "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` is built, keyed by content."""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}; known: {KERNELS}")
    h = hashlib.sha256(" ".join(FLAGS + PTXAS_REPORT).encode())
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, Path]:
    """Compile every library of ``names`` that is not built yet, in parallel.

    Returns ``{name: library path}``.  Raises ``RuntimeError`` with the
    compiler's output if any compile fails or times out.
    """
    paths = {name: library_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name, out in todo.items():
            # compile to a private name, rename into place when done, so a
            # concurrent process never loads a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            procs[name] = (subprocess.Popen(
                nvcc_command(nvcc, CSRC / f"{name}.cu", Path(tmp)),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                Path(tmp))
        failures = []
        for name, (proc, tmp) in procs.items():
            log, _ = proc.communicate(timeout=_NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                failures.append(f"--- {name} (exit {proc.returncode})\n{log}")
            else:
                todo[name].with_suffix(".log").write_text(log)
                os.replace(tmp, todo[name])
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return paths


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_SCALAR_ARG = re.compile(r"Li(-?\d+)E|Lb([01])E|f|\d+__nv_bfloat16")


def _template_args(rest: str) -> tuple[list[str], str]:
    """Parse a mangled template argument list after its ``I`` up to and
    including its ``E``: ints, bools, float, bf16 and ``repro::`` class
    templates (``NS_4TileILi32E...EE``).  Returns (args, what follows)."""
    args = []
    while rest and not rest.startswith("E"):
        nested = re.match(r"NS_(\d+)", rest)
        if nested is not None:
            end = nested.end() + int(nested.group(1))
            name, rest = rest[nested.end():end], rest[end:]
            if rest.startswith("I"):
                inner, rest = _template_args(rest[1:])
                name = f"{name}<{', '.join(inner)}>"
            if not rest.startswith("E"):
                break
            args.append(name)
            rest = rest[1:]
            continue
        t = _SCALAR_ARG.match(rest)
        if t is None:
            break
        if t.group(1) is not None:
            args.append(t.group(1))
        elif t.group(2) is not None:
            args.append("true" if t.group(2) == "1" else "false")
        else:
            args.append("float" if t.group(0) == "f" else "bf16")
        rest = rest[t.end():]
    return args, rest[1:]


def kernel_name(mangled: str) -> str:
    """A readable name of a ``repro::`` kernel's mangled symbol: the function
    and its template arguments (``flash_attention_wgmma_kernel<64>``,
    ``conv2d_kernel<Tile<32, 32, 4>, 4, true>``); other symbols as they
    are."""
    m = re.match(r"_ZN5repro(\d+)", mangled)
    if m is None:
        return mangled
    rest = mangled[m.end():]
    name, rest = rest[:int(m.group(1))], rest[int(m.group(1)):]
    if not rest.startswith("I"):
        return name
    args, _ = _template_args(rest[1:])
    return f"{name}<{', '.join(args)}>"


def resource_usage(name: str) -> dict[str, dict[str, int]]:
    """ptxas's report of the built library of kernel ``name``:
    ``{kernel: {"registers", "stack", "spill_stores", "spill_loads"}}``
    (bytes but the register count); empty if the library has no report."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return {}
    usage, current = {}, None
    for line in log.read_text().splitlines():
        if (m := _ENTRY.search(line)) is not None:
            current = usage.setdefault(kernel_name(m.group(1)), {})
        elif current is not None and (m := _FRAME.search(line)) is not None:
            current.update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        elif current is not None and (m := _REGS.search(line)) is not None:
            current["registers"] = int(m.group(1))
    return usage


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        _LIBS[name] = lib
    return lib


def check(code: int, what: str, error_string) -> None:
    """Raise if a C entry point returned a CUDA error code.

    ``error_string`` is the library's ``*_error_string`` entry point, which
    names the code (``cudaGetErrorString``).
    """
    if code != 0:
        name = error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} at launch: {name}")


__all__ = ["KERNELS", "build", "load", "check", "library_path", "nvcc_path",
           "nvcc_command", "resource_usage", "kernel_name"]
