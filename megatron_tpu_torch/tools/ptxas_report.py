"""ptxas's view of the port's kernels, one JSON line a kernel: the spill
bytes and the registers at launch that `nvcc -Xptxas -v` prints, ptxas's
note where it serialises a kernel's wgmma (C75xx: an info line, not a
warning, so a build log filtered for warnings never shows it), the
highest register the SASS uses, and the local-memory loads and stores in
the SASS by where they sit: before the kernel's first setmaxnreg
("entry"), after a decrease ("producer") or after an increase
("consumer"). A consumer that ptxas keeps far below its setmaxnreg grant
shows as a low highest register beside consumer spills.

Needs the CUDA toolkit (nvcc, cuobjdump; cu++filt for readable names), so
it runs on the machine with the card:

    python -m megatron_tpu_torch.tools.ptxas_report [SOURCE.cu ...]

With no argument it reports every source of ops/cuda_build.SOURCES. A
path compiles that file instead, with the headers beside it found first
and then csrc/'s, so a variant of a kernel is compared by editing a copy.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

from megatron_tpu_torch.ops import cuda_build

# cuda_build's target and optimisation flags, to a cubin instead of a
# shared library
CUBIN_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-cubin", "-Xptxas", "-v")


def _tool(name: str) -> str | None:
    found = shutil.which(name)
    if found:
        return found
    path = os.path.join(os.path.dirname(cuda_build._nvcc()), name)
    return path if os.path.exists(path) else None


def parse_ptxas(log: str) -> dict:
    """{mangled kernel: {"registers", "spill_stores", "spill_loads",
    "serialized"}} from `-Xptxas -v` output."""
    kernels, notes = {}, {}
    current = None
    for line in log.splitlines():
        note = re.search(r"\((C75\d\d)\)(.*)'(\w+)'", line)
        if note:
            notes[note.group(3)] = f"{note.group(1)}{note.group(2)}".strip()
            continue
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            current = kernels.setdefault(entry.group(1), {})
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            current["spill_stores"] = int(spill.group(1))
            current["spill_loads"] = int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            current["registers"] = int(used.group(1))
    for name, info in kernels.items():
        info["serialized"] = notes.get(name)
    return kernels


def parse_sass(sass: str) -> dict:
    """{mangled kernel: {"max_register", "local"}} from `cuobjdump -sass`:
    the highest R register named, and the local loads and stores (LDL,
    STL) counted by the setmaxnreg region they follow."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0].strip()
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", part)]
        local, region = {}, "entry"
        for line in part.splitlines():
            if "USETMAXREG" in line:
                region = "producer" if "DEALLOC" in line else "consumer"
            if re.search(r"\b(STL|LDL)\b", line):
                local[region] = local.get(region, 0) + 1
        out[name] = dict(max_register=max(regs) if regs else None,
                         local=local)
    return out


def _demangle(names):
    filt = _tool("cu++filt")
    if not filt or not names:
        return {n: n for n in names}
    lines = subprocess.run([filt], input="\n".join(names), text=True,
                           capture_output=True).stdout.splitlines()
    return dict(zip(names, lines)) if len(lines) == len(names) else {
        n: n for n in names}


def report(source: str) -> list:
    """One record a kernel of `source`, compiled as cuda_build compiles."""
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "kernels.cubin")
        build = subprocess.run(
            [cuda_build._nvcc(), *CUBIN_FLAGS, "-I",
             os.path.dirname(os.path.abspath(source)), "-I",
             str(cuda_build.CSRC), "-o", cubin, source],
            capture_output=True, text=True)
        if build.returncode != 0:
            raise RuntimeError(f"nvcc {source} failed:\n{build.stdout}"
                               f"{build.stderr}")
        kernels = parse_ptxas(build.stdout + build.stderr)
        sass = subprocess.run([_tool("cuobjdump") or "cuobjdump", "-sass",
                               cubin], capture_output=True, text=True,
                              check=True).stdout
    for name, info in parse_sass(sass).items():
        kernels.setdefault(name, {}).update(info)
    names = _demangle(sorted(kernels))
    return [dict(source=os.path.relpath(source), kernel=names[n], **kernels[n])
            for n in sorted(kernels)]


def main(argv=None) -> int:
    sources = (argv if argv is not None else sys.argv[1:]) or [
        str(p) for p in cuda_build.SOURCES.values()]
    for source in sources:
        for rec in report(source):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
