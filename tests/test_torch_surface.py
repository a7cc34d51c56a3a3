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

Every keyword whose reference default is a literal (a number, string,
boolean, None, or a tuple or list of them; ``jnp.X`` is read as
``torch.X``) must have the same default in the port, unless `DEFAULT_DIFFS`
names the keyword with its reason; an entry whose default agrees, or that
names no such keyword, fails too.
"""

import ast
import importlib
import inspect
import os

import pytest
import torch

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


# intended differences of a literal default: {item: reason}
_DRAW = ("the port's draws take the shape and the dtype from the caller, with the "
         "``torch.Generator``; JAX's default float has no counterpart in torch")
DEFAULT_DIFFS = {
    "infer/smc.py::smc_round(log_like_batched)": "the port's round takes the batched "
                                                 "likelihood only, as its first, "
                                                 "required argument",
    "models/dataset.py::DatasetBuilder.build(dtype)": "None is JAX's default float (the "
                                                      "x64 flag); the port's build takes "
                                                      "the dtype and the device from the "
                                                      "caller",
    "ops/fused.py::flagship_cov_soa(symmetric)": "None reads the reference's "
                                                 "``SOA_SYMMETRIC`` switch (not ported); "
                                                 "the port's default is that switch's "
                                                 "value, the symmetric builders",
    **{f"utils/priors.py::{c}.sample(shape)": _DRAW for c in (
        "Exponential", "Gamma", "GammaJointPrior", "IndependentJointPrior", "JointPrior",
        "LogNormal", "LogNormalJointPrior", "Normal", "NormalJointPrior",
        "ProductJointPrior", "SortedUniformJointPrior", "Uniform", "UniformJointPrior")},
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


_NO_LITERAL = object()


def _literal(node):
    """The value of a literal default (``jnp.X`` as ``torch.X``), else
    `_NO_LITERAL`."""
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "jnp"):
        return getattr(torch, node.attr, _NO_LITERAL)
    try:
        value = ast.literal_eval(node)
    except ValueError:
        return _NO_LITERAL
    if isinstance(value, (dict, set)):
        return _NO_LITERAL
    return value


def _defaults(fn):
    """{keyword: default node} of a function's keywords that have one."""
    a = fn.args
    positional = a.posonlyargs + a.args
    out = {x.arg: d for x, d in zip(positional[len(positional) - len(a.defaults):],
                                    a.defaults)}
    out.update({x.arg: d for x, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None})
    return out


def reference_items(rel):
    """{qualified item: port lookup} for one reference module: each item is
    ``(kind, name, member, keyword)``."""
    return _walk(rel)[0]


def reference_defaults(rel):
    """{qualified keyword item: its literal reference default} for one
    reference module."""
    return _walk(rel)[1]


def _walk(rel):
    with open(os.path.join(REF, rel)) as f:
        tree = ast.parse(f.read())
    items, defaults = {}, {}

    def add(kind, name, member=None, kw=None, fn=None):
        q = f"{rel}::{name}"
        if member:
            q += f".{member}"
        if kw:
            q += f"({kw})"
        items[q] = (kind, name, member, kw)
        node = _defaults(fn).get(kw) if fn is not None else None
        value = _NO_LITERAL if node is None else _literal(node)
        if value is not _NO_LITERAL:
            defaults[q] = value

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
                add("keyword", node.name, kw=kw, fn=node)
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            add("name", node.name)
            for b in node.body:
                if (isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name)
                        and _public(b.target.id)):
                    add("field", node.name, b.target.id)  # a NamedTuple's or dataclass's
                elif isinstance(b, ast.FunctionDef) and b.name == "__init__":
                    for kw in _keywords(b):
                        add("keyword", node.name, b.name, kw, fn=b)
                elif isinstance(b, ast.FunctionDef) and (_public(b.name)
                                                         or b.name == "__call__"):
                    add("member", node.name, b.name)
                    if any(isinstance(d, ast.Name) and d.id == "property"
                           for d in b.decorator_list):
                        continue
                    for kw in _keywords(b):
                        add("keyword", node.name, b.name, kw, fn=b)
    return items, defaults


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


def _same(ref, port):
    """A port default equal to the reference's literal one: a dtype the same
    object, a boolean a boolean, a number an equal number, a sequence the same
    kind with equal entries, anything else equal."""
    if isinstance(ref, torch.dtype) or isinstance(port, torch.dtype):
        return ref is port
    if isinstance(ref, bool) or isinstance(port, bool):
        return type(ref) is type(port) and ref == port
    if isinstance(ref, (tuple, list)):
        return (type(ref) is type(port) and len(ref) == len(port)
                and all(_same(r, p) for r, p in zip(ref, port)))
    if isinstance(ref, (int, float)):
        return isinstance(port, (int, float)) and ref == port
    return type(ref) is type(port) and ref == port


def default_diffs(rel):
    """{item: (reference default, port default)} of the keywords of module
    ``rel`` whose port default differs from the reference's literal one (a
    keyword the port lacks is `gaps`'s)."""
    try:
        mod = importlib.import_module(_port_module(rel))
    except ModuleNotFoundError:
        return {}
    items = reference_items(rel)
    out = {}
    for q, ref in reference_defaults(rel).items():
        _, name, member, kw = items[q]
        obj = getattr(mod, NAME_MAP.get(f"{rel}::{name}", name), None)
        if obj is not None and member is not None:
            obj = getattr(obj, member, None)
        try:
            params = inspect.signature(obj).parameters
        except (TypeError, ValueError):
            continue
        param = params.get(KEYWORD_MAP.get(kw, kw))
        if param is None:
            continue
        port = param.default
        if port is inspect.Parameter.empty or not _same(ref, port):
            out[q] = (ref, port)
    return out


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
    # and the literal defaults (a walk that read none would pass every module)
    defaults = reference_defaults("infer/pt.py")
    assert defaults["infer/pt.py::geometric_ladder(dtype)"] is torch.float32
    assert defaults["infer/pt.py::geometric_ladder(beta_min)"] == 0.1
    assert sum(len(reference_defaults(r)) for r in MODULES) > 300


@pytest.mark.parametrize("rel", MODULES)
def test_module_defaults(rel):
    """Every literal default of the reference module's functions, methods and
    constructors is the port's too, or `DEFAULT_DIFFS` gives the reason it
    is not; every `DEFAULT_DIFFS` entry of the module is such a difference."""
    diffs = default_diffs(rel)
    entries = {q for q in DEFAULT_DIFFS if q.startswith(rel + "::")}
    assert not set(diffs) - entries, (
        "defaults that differ from the reference's, in no DEFAULT_DIFFS entry: "
        + "; ".join(f"{q}: {diffs[q][0]!r} in the reference, {diffs[q][1]!r} in the port"
                    for q in sorted(set(diffs) - entries)))
    assert not entries - set(diffs), (
        f"stale DEFAULT_DIFFS entries (the defaults agree, or no literal default of a "
        f"reference keyword): {sorted(entries - set(diffs))}")
    for q in entries:
        assert DEFAULT_DIFFS[q].strip(), f"{q}: no reason"
