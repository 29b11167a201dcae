"""A caller written for the reference binds to the port: for every public
function and method of every ``tpubwa`` module, the reference's parameters
bind to the ``tpubwa_torch`` counterpart's signature (``inspect.signature``)
in two ways: the required ones by position and the rest by keyword, and
every positional parameter by position, each landing on the parameter of
the same name. The differences that are meant are listed below; anything
else is drift."""
import importlib
import inspect
import pkgutil

import pytest

import torch_cpu  # noqa: F401  (one PyTorch thread a process)
import tpubwa

P = inspect.Parameter

# reference names with no counterpart on purpose: the Pallas kernels are
# csrc/*.cu behind ops/sw.py and ops/sw_local.py, JAX's batch scans are the
# kernels' plain versions, the pytree methods have no use without JAX, and
# the prefix-doubling suffix array is the native SA-IS
DROPPED_MODULES = {"tpubwa.ops.sw_pallas", "tpubwa.extend.jax_extend"}
DROPPED_NAMES = {("tpubwa.index.builder", "suffix_array_doubling")}
DROPPED_METHODS = {"tree_flatten", "tree_unflatten"}

# reference parameters the port does not take: the TPU kernel switch
DROPPED_PARAMS = {"use_pallas"}

# parameters the port adds that a reference caller cannot pass: the device
# of an index or table, and the mesh a row-sharded index keeps its shards
# on (the reference hands the mesh to shard_map instead)
ADDED_PARAMS = {
    ("tpubwa.index.device", "DeviceIndex.from_host"): {"device"},
    ("tpubwa.seed.lut", "KmerLUT.build"): {"device"},
    ("tpubwa.dist.shard_index", "ShardedIndex.__init__"): {"mesh"},
}

# parameters the port takes under another name, and in another place: the
# histogram sum is over the port's one device where the reference's is over
# a JAX mesh (passed by keyword in both checks)
RENAMED_PARAMS = {("tpubwa.dist.mesh", "pe_hist_psum"): {"mesh": "device"}}

# port-only helpers such as dist/shard_index.py::_routed_rows are not
# checked: the walk starts from the reference's public names

MODULES = sorted(
    m.name for m in pkgutil.walk_packages(tpubwa.__path__, "tpubwa.")
    if not m.name.endswith("__main__") and m.name not in DROPPED_MODULES)


def public_callables(mod):
    """(qualified name, object, attribute path) of the module's own public
    functions and of its classes' public methods and constructors."""
    for name, obj in vars(mod).items():
        if name.startswith("_"):
            continue
        if getattr(inspect.unwrap(obj), "__module__", None) != mod.__name__:
            continue
        if inspect.isclass(obj):
            for mname, m in vars(obj).items():
                if (mname.startswith("_") and mname != "__init__") or \
                        mname in DROPPED_METHODS:
                    continue
                f = m.__func__ if isinstance(m, (staticmethod,
                                                 classmethod)) else m
                if inspect.isfunction(inspect.unwrap(f)):
                    yield f"{name}.{mname}", f, (name, mname)
        elif inspect.isfunction(inspect.unwrap(obj)) or callable(obj):
            yield name, obj, (name,)


def check_binds(ref_sig, port_sig, renamed, added):
    """Raise TypeError or AssertionError unless the reference's parameters
    bind to the port's signature both ways."""
    params = [p for p in ref_sig.parameters.values()
              if p.kind not in (P.VAR_POSITIONAL, P.VAR_KEYWORD)
              and p.name not in DROPPED_PARAMS]
    extra = {a: a for a in added
             if port_sig.parameters[a].default is P.empty}
    extra.update({new: new for new in renamed.values()})
    params = [p for p in params if p.name not in renamed]
    # the required parameters by position, the others by keyword
    args = [p.name for p in params
            if p.kind == P.POSITIONAL_ONLY or
            (p.kind == P.POSITIONAL_OR_KEYWORD and p.default is P.empty)]
    kw = {p.name: p.name for p in params if p.name not in args}
    bound = port_sig.bind(*args, **kw, **extra).arguments
    assert all(bound[v] == v for v in args), bound
    # every positional parameter by position, in the reference's order
    args = [p.name for p in params
            if p.kind in (P.POSITIONAL_ONLY, P.POSITIONAL_OR_KEYWORD)]
    kw = {p.name: p.name for p in params if p.kind == P.KEYWORD_ONLY}
    bound = port_sig.bind(*args, **kw, **extra).arguments
    assert all(bound[v] == v for v in args), bound


@pytest.mark.parametrize("modname", MODULES)
def test_reference_parameters_bind_to_the_port(modname):
    ref = importlib.import_module(modname)
    port = importlib.import_module("tpubwa_torch" + modname[len("tpubwa"):])
    problems = []
    for qual, obj, path in public_callables(ref):
        if (modname, qual) in DROPPED_NAMES:
            continue
        tgt = port
        for attr in path:
            tgt = getattr(tgt, attr, None)
        if tgt is None:
            problems.append(f"{qual}: no counterpart")
            continue
        ref_sig, port_sig = inspect.signature(obj), inspect.signature(tgt)
        try:
            check_binds(ref_sig, port_sig,
                        RENAMED_PARAMS.get((modname, qual), {}),
                        ADDED_PARAMS.get((modname, qual), set()))
        except (TypeError, AssertionError) as e:
            problems.append(f"{qual}: {ref_sig} does not bind to "
                            f"{port_sig}: {e}")
    assert not problems, "\n".join(problems)


def test_modules_cover_the_reference():
    """The walk sees the modules the port mirrors, so a module that fails
    to be listed cannot pass unchecked."""
    assert {"tpubwa.pipeline", "tpubwa.pair.rescue",
            "tpubwa.utils.profiling", "tpubwa.index.builder"} <= set(MODULES)
    assert len(MODULES) >= 25


def test_reference_keywords_bind():
    """The three calls that raised TypeError before: align_pe_stream's
    depth, PhaseTimer.phase's sync, ksw_align_batch's a_sc / b_sc."""
    import numpy as np
    import torch

    from tpubwa_torch.pair.rescue import ksw_align_batch
    from tpubwa_torch.pipeline import Aligner
    from tpubwa_torch.utils.profiling import PhaseTimer
    assert list(Aligner.align_pe_stream(object(), [], depth=2)) == []
    t = PhaseTimer()
    with t.phase("x", sync=None):
        pass
    assert t.counts["x"] == 1
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.integers(0, 4, (3, 20)), dtype=torch.int32)
    n = torch.full((3,), 20, dtype=torch.int32)
    one = torch.ones(3, dtype=torch.int32)
    a = ksw_align_batch(q, n, q, n, one, one, 6, 1, 6, 1, 1, 4)
    b = ksw_align_batch(q, n, q, n, one, one, a_sc=1, b_sc=4)
    assert torch.equal(a, b) and (a[:, 0] == 20).all()
    assert not torch.equal(a, ksw_align_batch(q, n, q, n, one, one,
                                              a_sc=2, b_sc=4))
