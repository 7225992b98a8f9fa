"""The port's JT-ABI prover (jepsen_tpu_torch.lint.rules_abi) against
seeded drifts, as tests/test_contract_prover.py holds the reference's.

Each test copies the port's REAL `csrc/` sources, `_build.py`,
`store.py` and `checker/elle/encode.py` into a fixture tree, applies
exactly one seeded mutation — a .cc or .cu signature, a PROTOTYPES
argtype or restype, an ABI version bumped on one side only, an export
without a prototype, a sidecar constant — and asserts the prover
reports exactly the expected finding. The unmutated tree must be
clean, so a prover that goes blind (a parser regression) or
trigger-happy (false drift) fails either way. The port's `cparse`
reads the reference's C sources as the reference's does.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import pytest

from jepsen_tpu.lint import cparse as ref_cparse
from jepsen_tpu_torch.lint import ProjectCtx, cparse, rules_abi

REPO = Path(__file__).resolve().parents[1]
PKG = "jepsen_tpu_torch"
HIST = f"{PKG}/csrc/hist_encode.cc"
BUILD = f"{PKG}/_build.py"
STORE = f"{PKG}/store.py"

_FIXTURE_FILES = (
    HIST, f"{PKG}/csrc/wgl.cc", f"{PKG}/csrc/closure_square.cu",
    f"{PKG}/csrc/knossos_dense.cu", f"{PKG}/csrc/knossos_frontier.cu",
    BUILD, STORE,
    f"{PKG}/checker/elle/encode.py",
)


@pytest.fixture()
def tree(tmp_path: Path) -> Path:
    for rel in _FIXTURE_FILES:
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO / rel, dst)
    return tmp_path


def prove(root: Path):
    ctx = ProjectCtx(root, [])
    out = []
    for r in rules_abi.RULES:
        out.extend(r.check_project(ctx))
    return out


def mutate(root: Path, rel: str, old: str, new: str) -> None:
    p = root / rel
    text = p.read_text()
    assert old in text, f"mutation anchor not found in {rel}: {old!r}"
    p.write_text(text.replace(old, new, 1))


def test_unmutated_tree_is_clean(tree):
    assert prove(tree) == []


def test_real_repo_is_clean():
    assert prove(REPO) == []


def test_every_export_of_every_source_is_proved():
    """The prover sees the five sources' whole C surface (the CUDA
    sources' single-declaration exports included) and every one of
    them is bound: the jt_ks_* splitter too."""
    ctx = ProjectCtx(REPO, [])
    st = rules_abi._state(ctx)
    assert set(st.native) == {f"{PKG}/csrc/{n}" for n in (
        "hist_encode.cc", "wgl.cc", "closure_square.cu",
        "knossos_dense.cu", "knossos_frontier.cu")}
    exports = st.exports()
    assert {"closure_square_launch", "closure_square_error_string",
            "knossos_dense_launch", "knossos_dense_error_string",
            "knossos_frontier_launch", "knossos_frontier_error_string",
            "jt_wgl_run", "jt_ks_split_file", "jt_ks_dims",
            "jt_ks_key_ids", "jt_ks_key_names_json",
            "jt_ks_free"} <= set(exports)
    assert set(exports) == set(st.protos)
    assert st.checks == {"jt_wgl_abi_version": (2, st.checks[
        "jt_wgl_abi_version"][1]), "jt_ha_abi_version": (5, st.checks[
            "jt_ha_abi_version"][1])}


# -- the seeded drifts ------------------------------------------------------

def test_cc_signature_drift_is_caught(tree):
    mutate(tree, HIST,
           "void jt_ks_dims(void* hp, int64_t out[4])",
           "void jt_ks_dims(void* hp, int64_t out[4], int64_t flags)")
    findings = prove(tree)
    assert [f.rule for f in findings] == ["JT-ABI-003"]
    assert "jt_ks_dims" in findings[0].message
    assert "2" in findings[0].message and "3" in findings[0].message


def test_cu_signature_drift_is_caught(tree):
    # the CUDA sources' single-declaration form is proved too
    mutate(tree, f"{PKG}/csrc/closure_square.cu",
           "int B, int T, int device, void* stream) {",
           "int B, int T, int device, void* stream, int flags) {")
    findings = prove(tree)
    assert [f.rule for f in findings] == ["JT-ABI-003"]
    assert "closure_square_launch" in findings[0].message
    assert "11" in findings[0].message and "10" in findings[0].message


def test_cu_arg_type_drift_is_caught(tree):
    mutate(tree, f"{PKG}/csrc/knossos_dense.cu",
           "int B, int C, int S, int V, int tier,",
           "int64_t B, int C, int S, int V, int tier,")
    findings = prove(tree)
    assert [f.rule for f in findings] == ["JT-ABI-003"]
    assert "knossos_dense_launch" in findings[0].message
    assert "arg 5" in findings[0].message


def test_sidecar_layout_constant_drift_is_caught(tree):
    mutate(tree, HIST, "int64_t PAD_TXNS = 128", "int64_t PAD_TXNS = 64")
    findings = prove(tree)
    assert [f.rule for f in findings] == ["JT-ABI-004"]
    assert "PAD_TXNS=64" in findings[0].message
    assert "_PAD_TXNS=128" in findings[0].message


def test_prototype_restype_drift_is_caught(tree):
    mutate(tree, BUILD,
           '"jt_xxh64_buf": (ctypes.c_uint64,',
           '"jt_xxh64_buf": (ctypes.c_int32,')
    findings = prove(tree)
    assert [f.rule for f in findings] == ["JT-ABI-003"]
    assert "jt_xxh64_buf" in findings[0].message
    assert "c_int32" in findings[0].message


def test_prototype_argtype_drift_is_caught(tree):
    mutate(tree, BUILD,
           '"jt_ha_encode_file": (ctypes.c_void_p, [ctypes.c_char_p]),',
           '"jt_ha_encode_file": (ctypes.c_void_p, [ctypes.c_void_p]),')
    findings = prove(tree)
    assert [f.rule for f in findings] == ["JT-ABI-003"]
    assert "arg 0" in findings[0].message


def test_abi_version_bump_must_land_on_both_sides(tree):
    mutate(tree, HIST,
           "int64_t jt_ha_abi_version() { return 5; }",
           "int64_t jt_ha_abi_version() { return 6; }")
    findings = prove(tree)
    assert [f.rule for f in findings] == ["JT-ABI-002"]
    assert "returns 6" in findings[0].message
    assert "pins 5" in findings[0].message


def test_abi_version_bump_on_the_python_side_only(tree):
    mutate(tree, BUILD, '("jt_wgl_abi_version", 2)',
           '("jt_wgl_abi_version", 3)')
    findings = prove(tree)
    assert [f.rule for f in findings] == ["JT-ABI-002"]
    assert "jt_wgl_abi_version" in findings[0].message


def test_new_export_without_prototype_is_caught(tree):
    mutate(tree, HIST,
           "void jt_ks_free(void* hp) { delete (SplitHandle*)hp; }",
           "void jt_ks_free(void* hp) { delete (SplitHandle*)hp; }\n"
           "int64_t jt_ks_new_thing(void* hp) { return 0; }")
    findings = prove(tree)
    assert [f.rule for f in findings] == ["JT-ABI-001"]
    assert "jt_ks_new_thing" in findings[0].message


def test_new_cu_export_without_prototype_is_caught(tree):
    p = tree / f"{PKG}/csrc/closure_square.cu"
    p.write_text(p.read_text() + '\nextern "C" int closure_square_'
                 'version() {\n  return 1;\n}\n')
    findings = prove(tree)
    assert [f.rule for f in findings] == ["JT-ABI-001"]
    assert "closure_square_version" in findings[0].message


def test_orphaned_prototype_is_caught(tree):
    mutate(tree, HIST, "void jt_ks_free(void* hp)",
           "void jt_ks_free2(void* hp)")
    assert sorted(f.rule for f in prove(tree)) == ["JT-ABI-001",
                                                    "JT-ABI-001"]


def test_dict_spread_prototype_drift_is_caught(tree):
    # prototypes bound through the `**{fn: ... for fn in (...)}` form
    mutate(tree, BUILD, '("jt_ha_appends", "jt_ha_reads", "jt_ha_edges",',
           '("jt_ha_appends", "jt_ha_readz", "jt_ha_edges",')
    assert sorted(f.rule for f in prove(tree)) == ["JT-ABI-001",
                                                    "JT-ABI-001"]


def test_prototype_under_the_wrong_library_is_caught(tree):
    mutate(tree, BUILD,
           '        "jt_wgl_abi_version": (ctypes.c_int64, []),\n',
           '        "jt_wgl_abi_version": (ctypes.c_int64, []),\n'
           '        "jt_ks_free": (None, [ctypes.c_void_p]),\n')
    mutate(tree, BUILD,
           '        "jt_ks_free": (None, [ctypes.c_void_p]),\n    },\n}',
           '    },\n}')
    findings = prove(tree)
    assert [f.rule for f in findings] == ["JT-ABI-001"]
    assert "jt_ks_free" in findings[0].message
    assert "'wgl'" in findings[0].message


def test_magic_string_drift_is_caught(tree):
    mutate(tree, STORE, 'ENCODED_MAGIC_V2 = b"JTENC02\\n"',
           'ENCODED_MAGIC_V2 = b"JTENC03\\n"')
    findings = prove(tree)
    assert [f.rule for f in findings] == ["JT-ABI-004"]
    assert "ENCODED_MAGIC_V2" in findings[0].message


def test_never_completed_drift_is_caught(tree):
    mutate(tree, f"{PKG}/checker/elle/encode.py",
           "NEVER_COMPLETED = np.int64(2**30)",
           "NEVER_COMPLETED = np.int64(2**31)")
    findings = prove(tree)
    assert [f.rule for f in findings] == ["JT-ABI-004"]
    assert "NEVER_COMPLETED" in findings[0].message


def test_missing_csrc_proves_nothing(tmp_path):
    (tmp_path / PKG).mkdir()
    shutil.copy(REPO / BUILD, tmp_path / BUILD)
    assert prove(tmp_path) == []


# -- cparse: the reference's parse, and the CUDA form ------------------------

@pytest.mark.parametrize("rel", ["native/hist_encode.cc", "native/wgl.cc",
                                 "native/graph_algo.cc"])
def test_cparse_reads_the_reference_sources_as_the_reference(rel):
    text = (REPO / rel).read_text()
    mine, ref = cparse.parse_native(text, rel), \
        ref_cparse.parse_native(text, rel)
    assert {k: (s.ret, s.args, s.line) for k, s in mine.exports.items()} \
        == {k: (s.ret, s.args, s.line) for k, s in ref.exports.items()}
    assert (mine.abi_versions, mine.constants, mine.magics,
            mine.sidecar_fields) == (ref.abi_versions, ref.constants,
                                     ref.magics, ref.sidecar_fields)


def test_parse_single_declaration_exports():
    abi = cparse.parse_native(
        'static int helper(int x) { return x; }\n'
        'extern "C" int k_launch(const void* m, void* out, int B,\n'
        '                        void* stream) {\n'
        '  if (B > 0) { return helper(B); }\n'
        '  return 0;\n}\n'
        'extern "C" const char* k_error_string(int code) {\n'
        '  return "";\n}\n')
    assert list(abi.exports) == ["k_launch", "k_error_string"]
    assert abi.exports["k_launch"].args == ("void*", "void*", "int",
                                            "void*")
    assert abi.exports["k_launch"].line == 2
    assert abi.exports["k_error_string"].ret == "char*"
