"""The C entries of the port's CUDA library against ``_build.SIGNATURES``.

``_build.lib()`` binds every name in ``SIGNATURES`` with ``ctypes``; a
name that no source defines, or that two sources define, shows only when
the library is built and loaded on the card.  These tests read the
sources instead: each entry is defined as an ``extern "C"`` function,
directly or through a ``VTPU_*_ENTRY(`` macro, exactly once in exactly
one ``csrc/*.cu``.
"""

import re

import pytest

from vtpu_torch.ops import _build

# entries bound by hand in _build.lib(), outside SIGNATURES
HELPERS = ("vtpu_paged_decode_scratch", "vtpu_error_string")


def _code(path) -> str:
    """A source with its comments removed."""
    text = open(path).read()
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    return re.sub(r"//[^\n]*", " ", text)


def _definitions() -> list:
    """(entry name, source file) for every definition in csrc/*.cu."""
    found = []
    for path in _build._sources():
        if not path.endswith(".cu"):
            continue
        code = _code(path)
        # direct definitions: extern "C" <type> name(...) {
        for m in re.finditer(
                r'extern\s+"C"\s+[\w\s\*]*?\b(vtpu_\w+)\s*\([^;{]*\)\s*\{',
                code):
            found.append((m.group(1), path))
        # macro invocations at the start of a line (not the #define)
        for m in re.finditer(r"^\s*VTPU_\w+_ENTRY\(\s*(vtpu_\w+)\s*,", code,
                             flags=re.M):
            found.append((m.group(1), path))
    return found


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_every_entry_is_defined_once_in_one_source(name):
    where = [path for entry, path in _definitions() if entry == name]
    assert len(where) == 1, f"{name} defined {len(where)} times: {where}"


def test_no_source_defines_an_entry_that_is_not_bound():
    bound = set(_build.SIGNATURES) | set(HELPERS)
    stray = sorted({entry for entry, _ in _definitions()} - bound)
    assert not stray


def test_no_entry_is_defined_twice():
    names = [entry for entry, _ in _definitions()]
    twice = sorted({n for n in names if names.count(n) > 1})
    assert not twice
    for helper in HELPERS:
        assert names.count(helper) == 1


def test_the_scanner_sees_both_forms_and_skips_comments(tmp_path,
                                                        monkeypatch):
    src = tmp_path / "x.cu"
    src.write_text(
        '#define VTPU_X_ENTRY(NAME, T) extern "C" int NAME(T a) { return 0; }\n'
        "VTPU_X_ENTRY(vtpu_a, float)\n"
        '// VTPU_X_ENTRY(vtpu_b, float)\n'
        '/* extern "C" int vtpu_c(int x) { return x; } */\n'
        'extern "C" const char* vtpu_d(int err) {\n  return "";\n}\n'
        'extern "C" int vtpu_e(int x);\n')
    monkeypatch.setattr(_build, "_sources", lambda: [str(src)])
    assert sorted(n for n, _ in _definitions()) == ["vtpu_a", "vtpu_d"]


def test_the_flash_entries_are_split_by_route():
    """bf16 -> bf16 forward, dq and dk/dv, the bf16 -> f32-out forward,
    and at 128 < hd <= 512 the bf16 forward, its f32-out twin and the
    bf16 backward (dq and dk/dv) on the tensor cores in bf16; every f32
    entry (forward, dq and dk/dv, at every hd) on the tensor cores as
    3xTF32; no flash entry is left on the CUDA cores."""
    where = {name: path.rsplit("/", 1)[-1] for name, path in _definitions()}
    tensor = {"vtpu_flash_fwd_bf16", "vtpu_flash_bwd_dq_bf16",
              "vtpu_flash_bwd_dkv_bf16", "vtpu_flash_fwd_bf16_f32out",
              "vtpu_flash_fwd_wide_bf16", "vtpu_flash_fwd_wide_bf16_f32out",
              "vtpu_flash_bwd_dq_wide_bf16", "vtpu_flash_bwd_dkv_wide_bf16"}
    tf32x3 = {"vtpu_flash_fwd_f32", "vtpu_flash_fwd_wide_f32",
              "vtpu_flash_bwd_dq_f32", "vtpu_flash_bwd_dkv_f32",
              "vtpu_flash_bwd_dq_wide_f32", "vtpu_flash_bwd_dkv_wide_f32"}
    flash = {name for name in _build.SIGNATURES
             if name.startswith("vtpu_flash_")}
    assert flash == tensor | tf32x3
    for name in flash:
        want = ("flash_attention_sm90.cu" if name in tensor
                else "flash_attention_tf32x3.cu")
        assert where[name] == want, name
    sources = {path.rsplit("/", 1)[-1] for path in _build._sources()}
    assert "flash_attention.cu" not in sources
