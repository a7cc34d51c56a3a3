"""The port covers the JAX package's public surface.

Every module of `gptools_tpu/` is read by AST (nothing of it is imported,
so JAX is not loaded): the names of each ``__all__``, every public
top-level function, class and constant, every public method and property
of those classes (and ``__call__``), their annotated fields (a NamedTuple's
or a dataclass's), and every keyword of those functions, methods and
constructors (``__init__``). Each must exist in the port's module of the same path
(imported: the port loads torch only), with three exceptions:

- `MODULE_MAP`: the two Pallas modules map to their CUDA counterparts,
  and `NAME_MAP` renames their functions;
- `KEYWORD_MAP`: a JAX PRNG ``key`` is a ``torch.Generator`` in the port;
- `NOT_PORTED`: what the port leaves out on purpose, each with its reason.

A reference item the port lacks that is not in `NOT_PORTED` fails its
module's case; so does a `NOT_PORTED` entry the port has (or that names no
reference item), and an entry with an empty reason.
"""

import ast
import importlib
import inspect
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "gptools_tpu")

MODULE_MAP = {
    "ops/evidence_pallas.py": "ops/evidence_cuda.py",
    "ops/pallas_cov.py": "ops/cov_cuda.py",
}
NAME_MAP = {
    # the reference builds the kernel's constants and returns its call; the
    # port builds the constants (`EvidenceData`), and `vag(thetaT, ev, aux)`
    # / `loglik(thetaT, ev, aux)` are the calls
    "ops/evidence_pallas.py::build_loglik_vag": "make_data",
    "ops/evidence_pallas.py::make_loglik_theta": "make_data",
    "ops/pallas_cov.py::pallas_supported": "cov_supported",
}
KEYWORD_MAP = {"key": "generator"}

_XLA = "exists for XLA's compiler; PyTorch runs eagerly"
_BATCHED = ("the port's samplers take the batched density (C, P) -> (C,) as ``logp`` "
            "itself, where the reference vmaps a per-chain one")
_PARAMS = ("passes run-specific values to the density so XLA reuses its compiled "
           "programs; in the eager port a closure does the same")
_INTERPRET = ("Pallas's interpret mode; the port's wrappers take the plain PyTorch "
              "version on CPU tensors and launch the kernel on CUDA tensors")
_AUX = ("the port's kernel takes its aux channels from the keys of the ``aux`` dict "
        "given to `vag` / `loglik`, not from flags fixed at build time")
_KEY = ("a JAX PRNG key threaded through the state; the port's steps draw from the "
        "``torch.Generator`` they are given")
_SMALL_CHOL = ("the reference's unrolled small-N factorization, written because XLA's "
               "batched Cholesky was slow on the TPU; the port's routes call "
               "torch.linalg.cholesky_ex, which computes the same factor")

NOT_PORTED = {
    "utils/xla_cache.py": "XLA's persistent compile cache; " + _XLA,
    "infer/chees.py::WARM_COMPILE_BACKENDS": "the backends on which `prewarm` compiles; "
                                             + _XLA,
    "infer/chees.py::prewarm": "compiles the chunk programs in background threads "
                               "while SMC runs; " + _XLA,
    "infer/chees.py::sample(chunk)": "iterations per compiled chunk program; " + _XLA,
    "infer/chees.py::sample(logp_batched)": _BATCHED,
    "infer/chees.py::sample(logp_params)": _PARAMS,
    "infer/chees.py::CheesState.key": _KEY,
    "infer/hmc.py::make_window_runner": "a compile-cached runner of warmup windows; the "
                                        "port runs windows eagerly through `run_window`",
    "infer/hmc.py::sample(transition_builder)": "a prebuilt transition factory that "
                                                "bypasses XLA's program cache; the port "
                                                "selects the transition by ``transition=``",
    "infer/hmc.py::sample(transition_spec)": "a hashable transition key for XLA's "
                                             "program cache; the port's ``transition``, "
                                             "``max_depth`` and ``divergence_threshold``",
    "infer/hmc.py::sample(logp_params)": _PARAMS,
    "infer/nuts.py::sample(logp_params)": _PARAMS,
    "infer/smc.py::SMCState.key": _KEY,
    "infer/smc.py::smc_round(log_like_fn)": "the per-particle likelihood the reference "
                                            "vmaps; the port's round takes "
                                            "``log_like_batched`` only",
    "infer/smc.py::smc_round(log_prior_fn)": "the per-particle prior the reference vmaps; "
                                             "the port's round takes "
                                             "``log_prior_batched``",
    "models/dataset.py::Dataset.tree_flatten": "registers the dataset as a JAX pytree",
    "models/dataset.py::Dataset.tree_unflatten": "registers the dataset as a JAX pytree",
    "ops/evidence.py::small_cholesky": _SMALL_CHOL,
    "ops/evidence.py::small_cholesky_b": _SMALL_CHOL,
    "ops/evidence.py::small_solve_lower": _SMALL_CHOL,
    "ops/evidence.py::small_solve_lower_b": _SMALL_CHOL,
    "ops/evidence.py::small_solve_upper_t": _SMALL_CHOL,
    "ops/evidence.py::small_solve_upper_t_b": _SMALL_CHOL,
    "ops/evidence_pallas.py::build_loglik_vag(interpret)": _INTERPRET,
    "ops/evidence_pallas.py::build_loglik_vag(has_mean)": _AUX,
    "ops/evidence_pallas.py::build_loglik_vag(has_noise)": _AUX,
    "ops/evidence_pallas.py::build_loglik_vag(warped)": _AUX,
    "ops/evidence_pallas.py::make_loglik_theta(interpret)": _INTERPRET,
    "ops/evidence_pallas.py::make_loglik_theta(has_mean)": _AUX,
    "ops/evidence_pallas.py::make_loglik_theta(has_noise)": _AUX,
    "ops/evidence_pallas.py::make_loglik_theta(warped)": _AUX,
    "ops/fused.py::SOA_SYMMETRIC": "the reference's global switch, for its A/B script "
                                   "`scripts/bench_soa.py`; the port selects the builders "
                                   "by ``flagship_cov_soa(symmetric=)``, whose default is "
                                   "the symmetric builders, the only ones whose K does "
                                   "not depend on the batch's width",
    "utils/native.py::build(quiet)": "the port's build always captures the compiler's "
                                     "output and raises with it when the build fails",
    "utils/native.py::load(auto_build)": "the port's `load` always builds at first use "
                                         "(a failed build raises), where the reference's "
                                         "returns None without a prebuilt library",
    "ops/pallas_cov.py::se_cov(interpret)": _INTERPRET,
    "ops/pallas_cov.py::gibbs_tanh_cov(interpret)": _INTERPRET,
    "ops/pallas_cov.py::cov_matrix_flagship(interpret)": _INTERPRET,
}


def _ref_modules():
    out = []
    for dirpath, _, files in os.walk(REF):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, f), REF))
    return sorted(out)


def _public(name):
    return not name.startswith("_")


def _keywords(fn):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs if x.arg not in ("self", "cls")]


def reference_items(rel):
    """{qualified item: port lookup} for one reference module: each item is
    ``(kind, name, member, keyword)``."""
    with open(os.path.join(REF, rel)) as f:
        tree = ast.parse(f.read())
    items = {}

    def add(kind, name, member=None, kw=None):
        q = f"{rel}::{name}"
        if member:
            q += f".{member}"
        if kw:
            q += f"({kw})"
        items[q] = (kind, name, member, kw)

    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                if t.id == "__all__":
                    for e in node.value.elts:
                        add("name", e.value)
                elif _public(t.id):
                    add("name", t.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
            add("name", node.name)
            for kw in _keywords(node):
                add("keyword", node.name, kw=kw)
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            add("name", node.name)
            for b in node.body:
                if (isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name)
                        and _public(b.target.id)):
                    add("field", node.name, b.target.id)  # a NamedTuple's or dataclass's
                elif isinstance(b, ast.FunctionDef) and b.name == "__init__":
                    for kw in _keywords(b):
                        add("keyword", node.name, b.name, kw)
                elif isinstance(b, ast.FunctionDef) and (_public(b.name)
                                                         or b.name == "__call__"):
                    add("member", node.name, b.name)
                    if any(isinstance(d, ast.Name) and d.id == "property"
                           for d in b.decorator_list):
                        continue
                    for kw in _keywords(b):
                        add("keyword", node.name, b.name, kw)
    return items


def _port_module(rel):
    path = MODULE_MAP.get(rel, rel)[:-3].replace("/", ".")
    if path == "__init__":
        return "gptools_tpu_torch"
    return "gptools_tpu_torch." + path.removesuffix(".__init__")


def _parameters(obj):
    try:
        return set(inspect.signature(obj).parameters)
    except (TypeError, ValueError):
        return None


def _has_field(cls, field):
    """A class field: an attribute, an annotation of the class or a base, or
    a constructor keyword."""
    if hasattr(cls, field):
        return True
    if any(field in getattr(c, "__annotations__", {}) for c in getattr(cls, "__mro__", ())):
        return True
    return field in (_parameters(cls) or ())


def gaps(rel):
    """The reference items of module ``rel`` that the port lacks."""
    try:
        mod = importlib.import_module(_port_module(rel))
    except ModuleNotFoundError:
        return {rel}
    missing = set()
    for q, (kind, name, member, kw) in reference_items(rel).items():
        pname = NAME_MAP.get(f"{rel}::{name}", name)
        obj = getattr(mod, pname, None)
        if obj is None:
            if kind == "name":
                missing.add(q)
            continue  # the name's own entry stands for its members
        if kind == "field":
            if not _has_field(obj, member):
                missing.add(q)
            continue
        if member is not None:
            target = getattr(obj, member, None)
            if target is None:
                if kind == "member":
                    missing.add(q)
                continue
            obj = target
        if kind == "keyword":
            params = _parameters(obj)
            if params is not None and KEYWORD_MAP.get(kw, kw) not in params:
                missing.add(q)
    return missing


MODULES = _ref_modules()


@pytest.mark.parametrize("rel", MODULES)
def test_module_surface(rel):
    """Every public item of the reference module is in the port or in
    `NOT_PORTED`, and every `NOT_PORTED` entry of the module is a reference
    item the port lacks."""
    lacking = gaps(rel)
    entries = {q for q in NOT_PORTED if q == rel or q.startswith(rel + "::")}
    assert not lacking - entries, (
        f"in neither the port nor NOT_PORTED: {sorted(lacking - entries)}")
    assert not entries - lacking, (
        f"stale NOT_PORTED entries (the port has them, or no reference item has "
        f"that name): {sorted(entries - lacking)}")


def test_not_ported_entries():
    """Each entry names a reference module and has a reason; each renamed
    reference item exists."""
    for q, reason in NOT_PORTED.items():
        assert q.split("::")[0] in MODULES, q
        assert isinstance(reason, str) and reason.strip(), f"{q}: no reason"
    for q in NAME_MAP:
        rel = q.split("::")[0]
        assert q in reference_items(rel), f"NAME_MAP entry {q} names no reference item"


def test_surface_walk_sees_known_items():
    """The walk reads ``__all__`` names, methods, properties and keywords
    (a walk that saw nothing would pass every module)."""
    items = reference_items("ops/kernels.py")
    assert "ops/kernels.py::Kernel.num_free_params" in items
    assert "ops/kernels.py::Kernel.__call__(ni)" in items
    assert "infer/__init__.py::SampleResult" in reference_items("infer/__init__.py")
    assert "ops/fused.py::SOA_SYMMETRIC" in reference_items("ops/fused.py")
    assert "models/gp.py::GPModel.__init__(evidence_backend)" in reference_items(
        "models/gp.py")
    assert "infer/hmc.py::SampleResult.log_prob" in reference_items("infer/hmc.py")
    assert "infer/chees.py::sample(chunk)" in reference_items("infer/chees.py")
    assert sum(len(reference_items(r)) for r in MODULES) > 1000
