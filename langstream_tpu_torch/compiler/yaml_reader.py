"""The YAML that LangStream application files use, without PyYAML.

The card's machine has no PyYAML, so the port reads app files itself.
:func:`load` returns what ``yaml.safe_load`` returns for them: block
mappings and sequences (an indentless sequence under a key too), plain,
single- and double-quoted scalars (multi-line, with PyYAML's folding and
escapes), ``|`` and ``>`` block scalars with their chomping and
indentation indicators, flow ``[...]`` and ``{...}`` collections (over
several lines too), and comments. Plain scalars are typed by PyYAML's
YAML 1.1 resolver: ``yes``/``no``/``on``/``off``/``true``/``false`` are
bools, ``~``/``null``/empty are None, ints take ``0x``/``0b``/octal
``0``/``_`` and base-60 forms, and a float needs a dot, with an
exponent only when it is signed (``1e3`` and ``1.0e3`` stay strings,
``1.0e+3`` is a float); ``YYYY-MM-DD`` is a ``datetime.date``.

Anything else (anchors, aliases, tags, ``?`` keys, merge keys,
directives, full timestamps, multi-document streams) raises
:class:`YamlError` naming the file and the line.

The scalar scanners follow PyYAML's ``scanner.py`` (``scan_plain``,
``scan_flow_scalar``, ``scan_block_scalar``), so folding agrees with it
character for character.
"""

from __future__ import annotations

import datetime
import re
from typing import Any, List, Optional

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9_]+(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_DATE = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                        (?:[Tt]|[ \t]+)[0-9][0-9]?
                        :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)

_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b",
    "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
    "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029",
}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_BLANK_OR_END = " \t\n\0"


class YamlError(ValueError):
    """A file this reader does not take, with its name and line."""


def _sexagesimal(text: str, cast) -> Any:
    value = 0
    base = 1
    for digit in reversed([cast(part) for part in text.split(":")]):
        value += digit * base
        base *= 60
    return value


def resolve_plain(text: str) -> Any:
    """PyYAML's implicit typing of a plain scalar (``SafeConstructor``)."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        sign = -1 if value[0] == "-" else 1
        if value[0] in "+-":
            value = value[1:]
        if value == ".inf":
            return sign * float("inf")
        if value == ".nan":
            return float("nan")
        if ":" in value:
            return sign * _sexagesimal(value, float)
        return sign * float(value)
    if _INT.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        if value[0] in "+-":
            value = value[1:]
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        if ":" in value:
            return sign * _sexagesimal(value, int)
        return sign * int(value)
    if _NULL.match(text):
        return None
    if _DATE.match(text):
        return datetime.date(int(text[:4]), int(text[5:7]), int(text[8:10]))
    if _TIMESTAMP.match(text):
        raise ValueError("timestamps are not supported")
    if text in ("<<", "="):
        raise ValueError(f"the {text!r} key is not supported")
    return text


class _Reader:
    def __init__(self, text: str, name: str) -> None:
        text = text.replace("\r\n", "\n").replace("\r", "\n").lstrip("\ufeff")
        self.s = text + "\0"
        self.p = 0
        self.name = name
        for number, line in enumerate(text.split("\n")):
            if line.startswith("%") or (line[:3] in ("---", "...") and line[3:4] in ("", " ", "\t")):
                raise YamlError(f"{name}:{number + 1}: directives and document markers are not "
                                "supported (one document a file)")

    # -- positions ------------------------------------------------------ #
    def error(self, message: str, at: Optional[int] = None) -> YamlError:
        at = self.p if at is None else at
        return YamlError(f"{self.name}:{self.s.count(chr(10), 0, at) + 1}: {message}")

    def col(self, at: Optional[int] = None) -> int:
        at = self.p if at is None else at
        return at - (self.s.rfind("\n", 0, at) + 1)

    def peek(self, k: int = 0) -> str:
        return self.s[min(self.p + k, len(self.s) - 1)]

    def skip(self) -> None:
        """Past spaces, line breaks and comments, to the next content."""
        s = self.s
        while True:
            c = s[self.p]
            if c in " \t\n":
                self.p += 1
            elif c == "#":
                while s[self.p] not in "\n\0":
                    self.p += 1
            else:
                return

    def skip_inline(self) -> None:
        while self.s[self.p] in " \t":
            self.p += 1

    def end_of_line(self) -> None:
        """Only spaces and a comment may follow a node on its line."""
        self.skip_inline()
        if self.s[self.p] == "#":
            while self.s[self.p] not in "\n\0":
                self.p += 1
        if self.s[self.p] not in "\n\0":
            raise self.error(f"unexpected {self.s[self.p]!r} after a value")

    def is_entry(self) -> bool:
        return self.peek() == "-" and self.peek(1) in _BLANK_OR_END

    # -- block structure ------------------------------------------------ #
    def document(self) -> Any:
        self.skip()
        if self.peek() == "\0":
            return None
        value = self.block_node(-1)
        self.skip()
        if self.peek() != "\0":
            raise self.error("expected the end of the document")
        return value

    def block_node(self, parent: int) -> Any:
        self.skip()
        if self.peek() == "\0" or self.col() <= parent:
            return None
        if self.is_entry():
            return self.block_sequence(self.col())
        if self.key_ahead():
            return self.block_mapping(self.col())
        return self.inline_node(parent)

    def key_ahead(self) -> bool:
        """Whether a simple key and its ``:`` start here, on this line."""
        saved = self.p
        try:
            c = self.peek()
            if c in "\"'":
                self.quoted()
                if "\n" in self.s[saved:self.p]:
                    return False
                self.skip_inline()
                return self.peek() == ":" and self.peek(1) in _BLANK_OR_END
            if c in "[{&*!%@`|>#":
                return False
            end = self.s.find("\n", self.p)
            line = self.s[self.p:end]
            for i, ch in enumerate(line):
                if ch == "#" and i > 0 and line[i - 1] in " \t":
                    return False
                if ch == ":" and (i + 1 == len(line) or line[i + 1] in " \t"):
                    return i > 0
            return False
        except YamlError:
            return False
        finally:
            self.p = saved

    def block_mapping(self, indent: int) -> dict:
        out: dict = {}
        first = True
        while True:
            self.skip()
            if self.peek() == "\0":
                break
            column = self.col()
            if column < indent or (column == indent and self.is_entry()):
                break
            if column > indent and not first:
                raise self.error("bad indentation of a mapping entry")
            if not self.key_ahead():
                raise self.error("expected a mapping key")
            first = False
            if self.peek() in "\"'":
                key: Any = self.quoted()
            else:
                start = self.p
                key = self.plain(indent, flow=False)
                try:
                    key = resolve_plain(key)
                except ValueError as error:
                    raise self.error(str(error), start) from None
            self.skip_inline()
            self.p += 1  # the ':'
            out[key] = self.mapping_value(indent)
        return out

    def mapping_value(self, indent: int) -> Any:
        self.skip_inline()
        if self.peek() in "#\n\0":
            self.skip()
            if self.peek() == "\0":
                return None
            column = self.col()
            if column > indent:
                return self.block_node(indent)
            if column == indent and self.is_entry():
                return self.block_sequence(indent)
            return None
        return self.inline_node(indent)

    def block_sequence(self, indent: int) -> list:
        out: list = []
        while True:
            self.skip()
            if self.peek() == "\0" or self.col() < indent:
                break
            if self.col() > indent:
                raise self.error("bad indentation of a sequence entry")
            if not self.is_entry():
                break
            self.p += 1
            self.skip_inline()
            if self.peek() in "#\n\0":
                self.skip()
                if self.peek() != "\0" and self.col() > indent:
                    out.append(self.block_node(indent))
                else:
                    out.append(None)
            else:
                out.append(self.block_node(indent))
        return out

    def inline_node(self, parent: int) -> Any:
        c = self.peek()
        if c in "&*!%@`":
            raise self.error("anchors, aliases, tags and reserved indicators are not supported")
        if c == "?" and self.peek(1) in _BLANK_OR_END:
            raise self.error("complex ('?') keys are not supported")
        if self.is_entry():
            raise self.error("sequence entries are not allowed here")
        if c in "|>":
            return self.block_scalar(parent)
        if c in "\"'":
            value: Any = self.quoted()
            self.end_of_line()
            return value
        if c in "[{":
            value = self.flow_node()
            self.end_of_line()
            return value
        start = self.p
        text = self.plain(parent, flow=False)
        if self.peek() == ":":
            raise self.error("mapping values are not allowed here")
        try:
            return resolve_plain(text)
        except ValueError as error:
            raise self.error(str(error), start) from None

    # -- scalars (PyYAML's scanner) -------------------------------------- #
    def plain(self, parent: int, flow: bool) -> str:
        """``scan_plain``: block continuation lines need a column past
        ``parent``; in flow context ``,?[]{}`` end the scalar."""
        s = self.s
        indent = parent + 1
        chunks: List[str] = []
        spaces: List[str] = []
        ends = ",[]{}" if flow else ""
        while True:
            if self.peek() == "#":
                break
            length = 0
            while True:
                ch = s[self.p + length]
                if (ch in _BLANK_OR_END
                        or (ch == ":" and s[min(self.p + length + 1, len(s) - 1)] in _BLANK_OR_END + ends)
                        or (flow and ch in ",?[]{}")):
                    break
                length += 1
            if length == 0:
                break
            chunks.extend(spaces)
            chunks.append(s[self.p:self.p + length])
            self.p += length
            spaces = self.plain_spaces()
            if not spaces or self.peek() == "#" or (not flow and self.col() < indent):
                break
        return "".join(chunks)

    def plain_spaces(self) -> List[str]:
        s = self.s
        length = 0
        while s[self.p + length] in " ":
            length += 1
        whitespace = s[self.p:self.p + length]
        self.p += length
        if s[self.p] == "\n":
            self.p += 1
            breaks: List[str] = []
            while s[self.p] in " \n":
                if s[self.p] == "\n":
                    breaks.append("\n")
                self.p += 1
            return breaks if breaks else [" "]
        return [whitespace] if whitespace else []

    def quoted(self) -> str:
        """``scan_flow_scalar``: single- or double-quoted, over lines."""
        s = self.s
        start = self.p
        quote = s[self.p]
        double = quote == '"'
        self.p += 1
        chunks: List[str] = []
        while True:
            chunks.extend(self._quoted_non_spaces(double, start))
            if s[self.p] == quote:
                break
            chunks.extend(self._quoted_spaces(start))
        self.p += 1
        return "".join(chunks)

    def _quoted_non_spaces(self, double: bool, start: int) -> List[str]:
        s = self.s
        chunks: List[str] = []
        while True:
            length = 0
            while s[self.p + length] not in "'\"\\\0 \t\n":
                length += 1
            if length:
                chunks.append(s[self.p:self.p + length])
                self.p += length
            ch = s[self.p]
            if not double and ch == "'" and s[self.p + 1] == "'":
                chunks.append("'")
                self.p += 2
            elif (double and ch == "'") or (not double and ch in '"\\'):
                chunks.append(ch)
                self.p += 1
            elif double and ch == "\\":
                self.p += 1
                ch = s[self.p]
                if ch in _ESCAPES:
                    chunks.append(_ESCAPES[ch])
                    self.p += 1
                elif ch in _ESCAPE_CODES:
                    width = _ESCAPE_CODES[ch]
                    digits = s[self.p + 1:self.p + 1 + width]
                    if len(digits) != width or any(d not in "0123456789ABCDEFabcdef" for d in digits):
                        raise self.error(f"bad escape \\{ch}{digits}")
                    chunks.append(chr(int(digits, 16)))
                    self.p += 1 + width
                elif ch == "\n":
                    self.p += 1
                    chunks.extend(self._quoted_breaks(start))
                else:
                    raise self.error(f"unknown escape \\{ch}")
            else:
                return chunks

    def _quoted_spaces(self, start: int) -> List[str]:
        s = self.s
        length = 0
        while s[self.p + length] in " \t":
            length += 1
        whitespace = s[self.p:self.p + length]
        self.p += length
        ch = s[self.p]
        if ch == "\0":
            raise self.error("unterminated quoted scalar", start)
        if ch == "\n":
            self.p += 1
            breaks = self._quoted_breaks(start)
            return breaks if breaks else [" "]
        return [whitespace]

    def _quoted_breaks(self, start: int) -> List[str]:
        s = self.s
        breaks: List[str] = []
        while True:
            while s[self.p] in " \t":
                self.p += 1
            if s[self.p] == "\0":
                raise self.error("unterminated quoted scalar", start)
            if s[self.p] != "\n":
                return breaks
            breaks.append("\n")
            self.p += 1

    def block_scalar(self, parent: int) -> str:
        """``scan_block_scalar``: ``|`` keeps line breaks, ``>`` folds
        them; ``-`` strips the final breaks, ``+`` keeps them all."""
        s = self.s
        folded = s[self.p] == ">"
        self.p += 1
        chomping: Optional[bool] = None
        increment: Optional[int] = None
        for _ in range(2):
            ch = s[self.p]
            if ch in "+-" and chomping is None:
                chomping = ch == "+"
                self.p += 1
            elif ch in "123456789" and increment is None:
                increment = int(ch)
                self.p += 1
        self.end_of_line()
        if s[self.p] == "\n":
            self.p += 1
        min_indent = max(parent + 1, 1)
        if increment is None:
            breaks: List[str] = []
            max_indent = 0
            while s[self.p] in " \n":
                if s[self.p] == "\n":
                    breaks.append("\n")
                    self.p += 1
                else:
                    self.p += 1
                    max_indent = max(max_indent, self.col())
            indent = max(min_indent, max_indent)
        else:
            indent = min_indent + increment - 1
            breaks = self._block_breaks(indent)
        chunks: List[str] = []
        line_break = ""
        while self.col() == indent and s[self.p] != "\0":
            chunks.extend(breaks)
            leading_non_space = s[self.p] not in " \t"
            end = self.p
            while s[end] not in "\0\n":
                end += 1
            chunks.append(s[self.p:end])
            self.p = end
            line_break = ""
            if s[self.p] == "\n":
                line_break = "\n"
                self.p += 1
            breaks = self._block_breaks(indent)
            if self.col() == indent and s[self.p] != "\0":
                if folded and line_break == "\n" and leading_non_space and s[self.p] not in " \t":
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(line_break)
            else:
                break
        if chomping is not False:
            chunks.append(line_break)
        if chomping is True:
            chunks.extend(breaks)
        return "".join(chunks)

    def _block_breaks(self, indent: int) -> List[str]:
        s = self.s
        breaks: List[str] = []
        while self.col() < indent and s[self.p] == " ":
            self.p += 1
        while s[self.p] == "\n":
            breaks.append("\n")
            self.p += 1
            while self.col() < indent and s[self.p] == " ":
                self.p += 1
        return breaks

    # -- flow collections ------------------------------------------------ #
    def flow_node(self) -> Any:
        c = self.peek()
        if c == "[":
            return self.flow_sequence()
        if c == "{":
            return self.flow_mapping()
        if c in "\"'":
            return self.quoted()
        if c in "&*!%@`|>":
            raise self.error(f"{c!r} is not supported in a flow collection")
        start = self.p
        text = self.plain(-1, flow=True)
        try:
            return resolve_plain(text)
        except ValueError as error:
            raise self.error(str(error), start) from None

    def flow_sequence(self) -> list:
        self.p += 1
        out: list = []
        while True:
            self.skip()
            if self.peek() == "]":
                self.p += 1
                return out
            if self.peek() == "\0":
                raise self.error("unterminated flow sequence")
            item = self.flow_node()
            self.skip()
            if self.peek() == ":":
                self.p += 1
                self.skip()
                item = {item: None if self.peek() in ",]" else self.flow_node()}
                self.skip()
            out.append(item)
            if self.peek() == ",":
                self.p += 1
            elif self.peek() != "]":
                raise self.error("expected ',' or ']' in a flow sequence")

    def flow_mapping(self) -> dict:
        self.p += 1
        out: dict = {}
        while True:
            self.skip()
            if self.peek() == "}":
                self.p += 1
                return out
            if self.peek() == "\0":
                raise self.error("unterminated flow mapping")
            key = self.flow_node()
            self.skip()
            value = None
            if self.peek() == ":":
                self.p += 1
                self.skip()
                if self.peek() not in ",}":
                    value = self.flow_node()
                    self.skip()
            out[key] = value
            if self.peek() == ",":
                self.p += 1
            elif self.peek() != "}":
                raise self.error("expected ',' or '}' in a flow mapping")


def load(text: str, name: str = "<string>") -> Any:
    """The value of one YAML document, as ``yaml.safe_load`` gives it."""
    return _Reader(text, name).document()


def load_file(path: str) -> Any:
    with open(path, "r", encoding="utf-8") as handle:
        return load(handle.read(), path)
