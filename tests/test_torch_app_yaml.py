"""The port's YAML reader (``compiler/yaml_reader.py``) against PyYAML.

- Every ``*.yaml`` under ``examples/``: the reader's value equals
  ``yaml.safe_load``'s.
- Hand-written documents of the forms app files use (PyYAML's YAML 1.1
  scalar typing, folding of plain and quoted scalars over lines, block
  scalars with their indicators, flow collections over lines, indentless
  sequences): the reader's value equals ``yaml.safe_load``'s.
- Anchors, aliases, tags, ``?`` keys, merge keys, directives and several
  documents in one stream raise ``YamlError`` naming the file and line.
"""

import pathlib

import pytest
import yaml

from langstream_tpu_torch.compiler import yaml_reader

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLE_FILES = sorted((REPO / "examples").rglob("*.yaml"))


def test_every_example_file_is_found():
    assert len(EXAMPLE_FILES) == 84


@pytest.mark.parametrize("path", EXAMPLE_FILES, ids=lambda p: str(p.relative_to(REPO / "examples")))
def test_example_file_equals_safe_load(path):
    with open(path) as handle:
        want = yaml.safe_load(handle)
    assert yaml_reader.load_file(str(path)) == want


DOCUMENTS = {
    "typing": (
        "a: 1e3\nb: 1.0e3\nc: 1.0e+3\nd: on\ne: no\nf: ~\ng: 0x1F\nh: 017\ni: 1_000\n"
        "j: 1:30\nk: .5\nl: -.inf\nm: 2024-01-02\nn: '1'\no: +12\np: 0b101\nq: 1.\nr: -0\n"
        "s: Off\nt: NULL\nu: 1e+3\nv: 12:30:00\nw: 190:20:30.15\nx: \"on\"\ny: 3.\nz: -1.5e-3\n"
    ),
    "plain over lines": "key: a plain\n  continued line\n\n  after blank\nnext: x # c\nh: a#b\n",
    "quoted over lines": (
        "s: \"a\\tb\\u00e9\\x41 \\\n  c\"\nt: 'it''s\n\n  folded'\n"
        "k: \"multi\n  line\n\n  quoted\"\n"
    ),
    "block scalars": (
        "lit: |\n  line1\n    indented\n\n  line3\n\nfold: >-\n  a\n  b\n\n  c\n   d\n  e\n"
        "keep: |+\n  x\n\n\nend: 1\nexplicit: |2\n    two extra\n  base\n"
        "folded: >\n  para one\n  continues\n\n  para two\n\n\nlast: |-\n  stripped\n\n"
    ),
    "sequences": "- a\n- - b\n  - c\n- k: v\n  k2: [1, 2, {x: y}]\n-\n  nested: true\n- \n",
    "indentless": "outer:\n- one\n- two: 2\n  three: 3\nafter: {a: 1, b: [x, 'y', \"z\"], c: }\n",
    "flow over lines": "flow: [a, b,\n  c, {d: e,\n   f: g}]\nempty: {}\nel: []\npair: [a: b, c]\n",
    "keys": "\"quoted key\": 1\n'single': 2\n1: int key\nyes: bool key\nurl: http://x.y:80/p\n",
    "nesting": "a:\n  b:\n    c: |\n      deep\n    d: 1\n  e: 2\nseq:\n  - name: a\n    config:\n      k: v\n  - name: b\n",
    "comments": "# head\nx: 'a' # comment\ny: [1, 2] # c\n\n# tail\n",
    "scalar document": "top scalar\n",
    "empty": "",
    "comment only": "# only a comment\n",
}


@pytest.mark.parametrize("name", sorted(DOCUMENTS))
def test_document_equals_safe_load(name):
    text = DOCUMENTS[name]
    assert yaml_reader.load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text, line", [
    ("a: 1\nb: &anchor 2\n", 2),
    ("a: 1\nb: *alias\n", 2),
    ("a: !!str 1\n", 1),
    ("a: 1\n---\nb: 2\n", 2),
    ("%YAML 1.1\na: 1\n", 1),
    ("a: 1\n? complex\n: key\n", 2),
    ("a: 1\n<<: {b: 1}\n", 2),
    ("a:\n  b: 2001-12-14t21:59:43.10-05:00\n", 2),
    ("a: b: c\n", 1),
    ("a: 'unterminated\n", 1),
])
def test_unsupported_forms_raise_with_file_and_line(text, line):
    with pytest.raises(yaml_reader.YamlError, match=rf"^app\.yaml:{line}: "):
        yaml_reader.load(text, "app.yaml")
