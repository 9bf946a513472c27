"""The port stands alone: no module of idgrec_torch/, no
scripts/torch_*.py and not chip_smoke.py imports jax or anything of
idgrec_tpu (AST scan of every import statement, including imports inside
functions). And every ROADMAP item the port's messages and docstrings
name exists in ROADMAP.md."""

from __future__ import annotations

import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
_FORBIDDEN = ("jax", "jaxlib", "idgrec_tpu")


def _port_files() -> list[pathlib.Path]:
    files = sorted((ROOT / "idgrec_torch").rglob("*.py"))
    files.extend(sorted((ROOT / "scripts").glob("torch_*.py")))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_modules(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


def test_port_files_exist():
    files = _port_files()
    assert all(f.exists() for f in files), [str(f) for f in files if not f.exists()]
    assert len(files) > 10


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in _FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_catches_a_jax_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from idgrec_tpu.ops import chainmm\n    import jax.numpy\n")
    assert _imported_modules(probe) == ["idgrec_tpu.ops", "jax.numpy"]


# "ROADMAP A.4", "ROADMAP B.B9", and lists after one mention ("ROADMAP A.4, A.8")
_REF_RUN = re.compile(r"ROADMAP\s+((?:[ABC]\.B?\d+[a-z]?)(?:(?:\s*[,/]\s*|\s+and\s+)[ABC]\.B?\d+[a-z]?)*)")
_REF = re.compile(r"([ABC])\.(B?\d+[a-z]?)")


def _roadmap_refs() -> list[tuple[str, str]]:
    """(file, 'A.4') for every ROADMAP item named in a string of the
    port's package (docstrings and messages; f-strings included)."""
    found = set()
    for path in sorted((ROOT / "idgrec_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                text = " ".join(node.value.split())
                for run in _REF_RUN.findall(text):
                    for section, item in _REF.findall(run):
                        found.add((str(path.relative_to(ROOT)), f"{section}.{item}"))
    return sorted(found)


def _roadmap_items() -> set[str]:
    """The items ROADMAP.md has: numbered entries of a lettered section
    ("### A." then "4. **...") and kernel entries ("- **B9 · ...")."""
    items, section = set(), None
    for line in (ROOT / "ROADMAP.md").read_text().splitlines():
        head = re.match(r"### ([A-Z])\. ", line)
        if head:
            section = head.group(1)
        elif line.startswith("## "):
            section = None
        elif section:
            m = re.match(r"(\d+)\. ", line) or re.match(r"- \*\*(B\d+[a-z]?)\b", line)
            if m:
                items.add(f"{section}.{m.group(1)}")
    return items


def test_roadmap_items_are_found():
    items = _roadmap_items()
    assert {"A.4", "A.7", "A.9", "B.B4", "B.B9"} <= items and "A.99" not in items
    refs = _roadmap_refs()
    assert len(refs) >= 8 and ("idgrec_torch/parallel/spmm_shard.py", "A.9") in refs


@pytest.mark.parametrize("path,ref", _roadmap_refs(), ids=lambda v: str(v))
def test_named_roadmap_item_exists(path, ref):
    assert ref in _roadmap_items(), f"{path} names ROADMAP {ref}, which ROADMAP.md does not have"


def test_ref_scan_reads_lists_after_one_mention():
    text = "dense/gather: ROADMAP A.4, bitpack: ROADMAP A.8; see ROADMAP A.3/A.4 and B.B2"
    runs = [_REF.findall(r) for r in _REF_RUN.findall(text)]
    assert runs == [[("A", "4")], [("A", "8")], [("A", "3"), ("A", "4"), ("B", "B2")]]
