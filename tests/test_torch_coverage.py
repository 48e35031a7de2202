"""The port is whole: what the JAX package offers, ``swiftsnails_tpu_torch``
offers too, or a table here says where it went and why.

Both packages are read with ``ast``; nothing is imported, so this needs no
JAX runtime. Four checks:

* **modules**: every module of ``swiftsnails_tpu/`` has a file of the same
  path in the port (or a reason in :data:`MODULES_NOT_PORTED`), and each of
  its public top-level ``def`` and ``class`` names is defined at the top
  level of that file, or named in :data:`COUNTERPARTS` with the place in the
  port that does its work and the reason it is not the same name;
* **the table itself**: each entry's JAX name exists, the port does not in
  fact have it under the same name, and its port location exists;
* **config keys**: every key the JAX package reads through ``Config``'s
  typed getters (``get_int``, ``get_float``, ``get_str``, ``get_bool``) is
  read by the port;
* **CLI**: every ``cmd == "..."`` command of the JAX ``cli.py`` and every
  ``--flag`` the JAX package declares with ``add_argument`` exists in the
  port;
* **environment**: every variable the JAX package reads (``os.environ``,
  ``getenv``) is read by the port, or is in :data:`ENV_NOT_PORTED` with its
  reason;
* **the repo's tools**: every file under ``tools/`` has a twin of the same
  stem under ``swiftsnails_tpu_torch/tools/``, a port CLI command
  (:data:`TOOLS_AS_COMMANDS`), or a reason (:data:`TOOLS_NOT_PORTED`);
* **packaging** (``pyproject.toml``, read with ``tomllib``): every source
  the port builds at run time matches a ``package-data`` glob of the port,
  and the ``snails-torch`` script names a function the port defines.
"""

from __future__ import annotations

import ast
import fnmatch
import tomllib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "swiftsnails_tpu"
PORT = ROOT / "swiftsnails_tpu_torch"
TOOLS = ROOT / "tools"

# JAX modules with no file in the port (ROADMAP.md, Queue 1: "Not to port")
MODULES_NOT_PORTED = {
    "utils/compat.py": "shims over JAX releases (shard_map's move and its keyword, the "
                       "Pallas TPU API's renames); the port uses neither",
    "utils/platform_pin.py": "pins JAX to the virtual CPU platform around this image's TPU "
                             "plugin; the port picks its device by argument",
}

# "JAX module:name" -> ("port module:name" that does its work, why not the same name)
COUNTERPARTS = {
    "ops/rowdma.py:on_tpu": (
        "ops/rowdma.py:gather_rows",
        "JAX's backend check for Pallas interpret mode; each port wrapper dispatches on "
        "its tensor's device: the plain version on the CPU, the CUDA kernel on the card"),
    "ops/fused_sgns.py:get_prep_impl": (
        "ops/fused_sgns.py:merged_prep",
        "reads the TPU prep's scatter-versus-sort A/B switch; the port has one prep, "
        "merged_prep, and no switch"),
    "ops/fused_sgns.py:set_prep_impl": (
        "ops/fused_sgns.py:merged_prep",
        "flips the TPU prep's scatter-versus-sort A/B and clears jit caches; the port "
        "has one prep, merged_prep, and no switch"),
    "ops/fused_sgns.py:dedup_prep": (
        "ops/fused_sgns.py:merged_prep",
        "the dedup kernel's XLA prologue; the port's merged kernels take merged_prep's "
        "runs in its place"),
    "ops/hashing.py:murmur_fmix64_pair": (
        "ops/hashing.py:murmur_fmix64",
        "fmix64 on (hi, lo) uint32 pairs, as a TPU has no 64-bit lanes; the port's "
        "murmur_fmix64 computes it on int64"),
    "parallel/comm.py:seed_from_key": (
        "parallel/comm.py:_seed_tensor",
        "turns a JAX PRNG key into the codec's uint32 dither seed; the port passes the "
        "seed itself, an int or a tensor"),
    "parallel/store.py:gather_rows": (
        "ops/rowdma.py:gather_rows",
        "a jitted XLA read of a cache plane's rows; the port's tier reads them with the "
        "rowdma gather_rows kernel"),
    "parallel/store.py:scatter_rows": (
        "ops/rowdma.py:scatter_write_rows",
        "a jitted XLA install of rows into a cache plane; the port's tier installs them "
        "with the rowdma scatter_write_rows kernel"),
    "parallel/transfer.py:pull_collective_slots": (
        "parallel/transfer.py:pull_collective",
        "an alias of pull_collective over a cache plane, called nowhere in the JAX "
        "package; the port's meshed tier calls the planes' own pulls on its cache shard"),
    "parallel/transfer.py:push_collective_slots": (
        "parallel/transfer.py:push_collective",
        "an alias of push_collective over a cache plane, called nowhere in the JAX "
        "package; the port's meshed tier calls the planes' own pushes on its cache shard"),
    "parallel/placement.py:row_wire_bytes": (
        "parallel/comm.py:row_wire_bytes",
        "the wire bytes of a row under a comm_dtype; the port keeps it beside the "
        "codecs that define those bytes"),
    "telemetry/audit.py:collective_stats": (
        "parallel/comm.py:scope",
        "parses optimized HLO text; the port compiles no HLO and counts each collective "
        "where it is called, by op and scope"),
    "telemetry/audit.py:collective_bytes": (
        "parallel/comm.py:comm_bytes",
        "sums collective bytes from HLO text; the port counts them where they are called"),
    "telemetry/audit.py:audit_compiled": (
        "telemetry/audit.py:audit_step",
        "reads a compiled XLA executable's cost and memory analysis; the port has no "
        "compiled program, and audit_step reports the counted collectives of a step"),
    "telemetry/audit.py:compiled_collective_bytes": (
        "telemetry/audit.py:audit_step",
        "compiles a function to sum its HLO collectives' bytes; the port's audit_step "
        "runs the step and reads the counters"),
}

# environment variables the JAX package reads and the port does not -> why
ENV_NOT_PORTED = {
    "JAX_PLATFORMS": "JAX's runtime: picks JAX's backend (utils/platform_pin.py); the port "
                     "picks its device by argument",
    "XLA_FLAGS": "JAX's runtime: the XLA compiler's flags (utils/platform_pin.py); the port "
                 "compiles no XLA",
    "JAX_THREEFRY_PARTITIONABLE": "JAX's runtime: a user's override of the PRNG lowering "
                                  "the JAX package sets; torch has no such lowering",
    "SSN_PREP_IMPL": "the TPU prep's scatter-versus-sort A/B switch, read by get_prep_impl "
                     "(in COUNTERPARTS); the port has one prep, merged_prep, and no switch",
}

# files of the repo's tools/ that a port CLI command replaces -> the command
TOOLS_AS_COMMANDS = {
    "ledger_report.py": "ledger-report",
    "trace_summary.py": "trace-summary",
    "ops_report.py": "ops",
}

# files of the repo's tools/ with no port twin -> why (ROADMAP.md, Queue 1:
# "Not to port")
TOOLS_NOT_PORTED = {
    "kernel_lab.py": "times Pallas kernel variants on the TPU; chip_smoke.py's kernel, "
                     "kernels and profile lines take the port's measures on the card",
    "compile_probe.py": "probes Mosaic's compile of the TPU kernels; the port builds with nvcc",
    "dedup_profile.py": "profiles the TPU dedup prep; chip_smoke.py's profile lines cover "
                        "the port's merged paths",
    "calibrate_baseline.py": "calibrates the TPU bench's baseline; the port has no bench yet",
    "r5_measure.sh": "drives TPU measurements through this image's TPU plugin",
    "gen_data.py": "imports only numpy and writes corpora both packages read",
}

# the sources the port compiles at run time (nvcc, g++), by suffix
BUILT_SUFFIXES = (".cu", ".cuh", ".cpp", ".c", ".h")

CONFIG_GETTERS = ("get_int", "get_float", "get_str", "get_bool")


def _modules(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p for p in sorted(root.rglob("*.py"))
            if not {"build", "__pycache__"} & set(p.relative_to(root).parts)}


JAX_MODULES = _modules(JAX)
PORT_MODULES = _modules(PORT)
_TREES: dict = {}


def _tree(path: Path) -> ast.Module:
    if path not in _TREES:
        _TREES[path] = ast.parse(path.read_text(encoding="utf-8"), str(path))
    return _TREES[path]


def _top_level(body) -> list:
    """Statements at module level, with those under a top-level ``if``,
    ``try`` or ``with`` (an optional import's fallback definitions)."""
    out = []
    for node in body:
        out.append(node)
        if isinstance(node, (ast.If, ast.Try, ast.With)):
            for part in ("body", "orelse", "finalbody", "handlers"):
                for sub in getattr(node, part, []):
                    out.extend(_top_level(sub.body if isinstance(sub, ast.ExceptHandler)
                                          else [sub]))
    return out


def _defs(path: Path) -> set:
    """Names of the top-level functions and classes of a module."""
    return {n.name for n in _top_level(_tree(path).body)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))}


def _public(path: Path) -> set:
    return {n for n in _defs(path) if not n.startswith("_")}


def _walk(modules: dict):
    for path in modules.values():
        yield from ast.walk(_tree(path))


def _config_keys(modules: dict) -> set:
    return {n.args[0].value for n in _walk(modules)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr in CONFIG_GETTERS and n.args
            and isinstance(n.args[0], ast.Constant) and isinstance(n.args[0].value, str)}


def _flags(modules: dict) -> set:
    return {a.value for n in _walk(modules)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "add_argument"
            for a in n.args if isinstance(a, ast.Constant) and isinstance(a.value, str)
            and a.value.startswith("--")}


def _commands(cli: Path) -> set:
    """The strings ``cmd`` is compared with (``==`` or ``in`` a tuple)."""
    out = set()
    for n in ast.walk(_tree(cli)):
        if (isinstance(n, ast.Compare) and isinstance(n.left, ast.Name)
                and n.left.id == "cmd"):
            for op, right in zip(n.ops, n.comparators):
                if isinstance(op, ast.Eq) and isinstance(right, ast.Constant):
                    out.add(right.value)
                elif isinstance(op, ast.In) and isinstance(right, (ast.Tuple, ast.List)):
                    out.update(e.value for e in right.elts if isinstance(e, ast.Constant))
    return out


def _str_consts(tree: ast.Module) -> dict:
    """Module-level ``NAME = "text"`` bindings."""
    return {t.id: n.value.value for n in tree.body if isinstance(n, ast.Assign)
            and isinstance(n.value, ast.Constant) and isinstance(n.value.value, str)
            for t in n.targets if isinstance(t, ast.Name)}


def _is_environ(node) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == "environ"


def _env_keys(modules: dict) -> set:
    """Variables read through ``os.environ.get(K)``, ``os.environ[K]``,
    ``K in os.environ`` and ``os.getenv(K)``, whatever ``os`` is bound to;
    ``K`` a string or a module-level string constant."""
    out = set()
    for path in modules.values():
        tree = _tree(path)
        consts = _str_consts(tree)

        def text(node):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                return node.value
            if isinstance(node, ast.Name):
                return consts.get(node.id)
            return None

        for n in ast.walk(tree):
            key = None
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) and n.args:
                if (n.func.attr == "get" and _is_environ(n.func.value)) or \
                        n.func.attr == "getenv":
                    key = text(n.args[0])
            elif isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Load) \
                    and _is_environ(n.value):
                key = text(n.slice)
            elif isinstance(n, ast.Compare) and len(n.ops) == 1 \
                    and isinstance(n.ops[0], (ast.In, ast.NotIn)) \
                    and _is_environ(n.comparators[0]):
                key = text(n.left)
            if key:
                out.add(key)
    return out


def _tool_files() -> dict:
    return {p.name: p for p in sorted(TOOLS.iterdir())
            if p.is_file() and p.suffix in (".py", ".sh")}


def _pyproject() -> dict:
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)


def test_the_readers_see_both_packages():
    """The extractors are not vacuous: they find what is known to be there."""
    assert len(JAX_MODULES) >= 100 and len(PORT_MODULES) >= len(JAX_MODULES) - 2
    ledger = "telemetry/ledger.py"
    assert {"Ledger", "validate_bench_payload", "derive_last_good"} <= _public(JAX / ledger)
    assert "_BENCH_REQUIRED" not in _public(JAX / ledger)
    keys = _config_keys(JAX_MODULES)
    assert len(keys) >= 100 and {"learning_rate", "comm_dtype", "table_tier"} <= keys
    assert {"--baseline-file", "--check-regression"} <= _flags(JAX_MODULES)
    assert {"train", "serve", "ledger-report", "net-serve"} <= _commands(JAX / "cli.py")
    env = _env_keys(JAX_MODULES)
    assert {"SSN_NATIVE_SO", "SSN_LEDGER_PATH", "JAX_PLATFORMS",
            "JAX_THREEFRY_PARTITIONABLE"} <= env  # .get, [..], `not in`, `import os as _os`
    assert {"RANK", "LOCAL_RANK", "SSN_NATIVE_SO"} <= _env_keys(PORT_MODULES)
    assert {"launch_pod.sh", "native_sanitize.sh", "gen_data.py"} <= set(_tool_files())


@pytest.mark.parametrize("module", sorted(JAX_MODULES))
def test_module_has_its_counterparts(module):
    if module in MODULES_NOT_PORTED:
        assert module not in PORT_MODULES, f"{module} is ported: take it out of the table"
        assert MODULES_NOT_PORTED[module]
        return
    assert module in PORT_MODULES, f"the port has no {module}"
    ported = _defs(PORT_MODULES[module])
    missing = sorted(name for name in _public(JAX_MODULES[module])
                     if name not in ported and f"{module}:{name}" not in COUNTERPARTS)
    assert not missing, f"{module}: no counterpart in the port for {missing}"


@pytest.mark.parametrize("entry", sorted(COUNTERPARTS))
def test_counterpart_table_entry_holds(entry):
    module, name = entry.split(":")
    location, reason = COUNTERPARTS[entry]
    assert module in JAX_MODULES and name in _public(JAX_MODULES[module]), (
        f"{entry} names nothing in the JAX package")
    assert module in PORT_MODULES and name not in _defs(PORT_MODULES[module]), (
        f"the port has {entry} under the same name: take it out of the table")
    port_module, port_name = location.split(":")
    assert port_module in PORT_MODULES, f"{entry}: the port has no {port_module}"
    assert port_name in _defs(PORT_MODULES[port_module]), (
        f"{entry}: the port's {port_module} defines no {port_name}")
    assert reason.strip()


def test_modules_not_ported_are_jax_modules():
    assert set(MODULES_NOT_PORTED) <= set(JAX_MODULES)


def test_every_config_key_is_read_by_the_port():
    missing = sorted(_config_keys(JAX_MODULES) - _config_keys(PORT_MODULES))
    assert not missing, f"config keys the port never reads: {missing}"


def test_every_cli_command_exists_in_the_port():
    missing = sorted(_commands(JAX / "cli.py") - _commands(PORT / "cli.py"))
    assert not missing, f"CLI commands the port lacks: {missing}"


def test_every_cli_flag_exists_in_the_port():
    missing = sorted(_flags(JAX_MODULES) - _flags(PORT_MODULES))
    assert not missing, f"flags the port lacks: {missing}"


def test_every_environment_variable_is_read_by_the_port():
    missing = sorted(_env_keys(JAX_MODULES) - _env_keys(PORT_MODULES) - set(ENV_NOT_PORTED))
    assert not missing, f"environment variables the port never reads: {missing}"


@pytest.mark.parametrize("key", sorted(ENV_NOT_PORTED))
def test_env_table_entry_holds(key):
    assert key in _env_keys(JAX_MODULES), f"the JAX package reads no {key}"
    assert key not in _env_keys(PORT_MODULES), f"the port reads {key}: take it out"
    assert ENV_NOT_PORTED[key].strip()
    if key == "SSN_PREP_IMPL":
        assert "ops/fused_sgns.py:get_prep_impl" in COUNTERPARTS


@pytest.mark.parametrize("name", sorted(_tool_files()))
def test_every_repo_tool_has_a_port_counterpart(name):
    twins = sorted(p.name for p in (PORT / "tools").iterdir()
                   if p.is_file() and p.stem == Path(name).stem)
    tabled = [t for t in (TOOLS_AS_COMMANDS, TOOLS_NOT_PORTED) if name in t]
    if twins:
        assert not tabled, f"tools/{name} has a port twin {twins}: take it out of the table"
    elif name in TOOLS_AS_COMMANDS:
        assert TOOLS_AS_COMMANDS[name] in _commands(PORT / "cli.py"), (
            f"tools/{name}: the port's CLI has no {TOOLS_AS_COMMANDS[name]!r}")
    else:
        assert name in TOOLS_NOT_PORTED, (
            f"tools/{name} has no twin under swiftsnails_tpu_torch/tools/, no port "
            "command and no reason")
        assert TOOLS_NOT_PORTED[name].strip()


def test_tool_tables_name_repo_tools():
    assert set(TOOLS_AS_COMMANDS) | set(TOOLS_NOT_PORTED) <= set(_tool_files())
    # gen_data.py serves both packages: it imports neither
    imported = {a.name.split(".")[0] for n in ast.walk(_tree(TOOLS / "gen_data.py"))
                if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module.split(".")[0] for n in ast.walk(_tree(TOOLS / "gen_data.py"))
                 if isinstance(n, ast.ImportFrom) and n.module}
    assert not imported & {"jax", "swiftsnails_tpu", "torch", "swiftsnails_tpu_torch"}


def test_every_built_source_is_package_data():
    globs = _pyproject()["tool"]["setuptools"]["package-data"]["swiftsnails_tpu_torch"]
    sources = sorted(p.relative_to(PORT).as_posix() for p in PORT.rglob("*")
                     if p.suffix in BUILT_SUFFIXES and "build" not in p.relative_to(PORT).parts)
    assert {"csrc/rowdma.cu", "csrc/sgns_device.cuh", "data/native/libsnails.cpp"} <= set(sources)
    missing = [s for s in sources if not any(fnmatch.fnmatchcase(s, g) for g in globs)]
    assert not missing, f"sources an installed port could not build: {missing}"


def test_the_port_script_names_a_port_function():
    scripts = _pyproject()["project"]["scripts"]
    assert scripts["snails"] == "swiftsnails_tpu.cli:main"
    module, func = scripts["snails-torch"].split(":")
    path = ROOT / (module.replace(".", "/") + ".py")
    assert module.split(".")[0] == "swiftsnails_tpu_torch" and path.is_file()
    assert func in _defs(path)
