"""Text-processing agents.

The port's own copy of ``langstream_tpu/agents/text.py``, the reference's
``langstream-agents-text-processing`` module: ``text-splitter``
(``TextSplitterAgent.java:29``, a RecursiveCharacterTextSplitter with a
token-estimate length), ``document-to-json`` (``DocumentToJsonAgent.java:29``),
``language-detector`` (``LanguageDetectorAgent.java:27``),
``text-normaliser``, and ``text-extractor`` (Tika in the reference; here
a dependency-free extractor for text-like formats, refusing PDF).
"""

from __future__ import annotations

import html
import html.parser
import json
import re
import unicodedata
from typing import Any, Callable, Dict, List, Optional

from langstream_tpu_torch.api.agent import SingleRecordProcessor
from langstream_tpu_torch.api.records import Record


# ---------------------------------------------------------------------- #
# text splitting
# ---------------------------------------------------------------------- #
class RecursiveCharacterTextSplitter:
    """Recursive splitter matching the reference's port of LangChain's
    algorithm (``textsplitter/RecursiveCharacterTextSplitter`` usage in
    ``TextSplitterAgent.java``): try separators in order, split greedily,
    merge adjacent pieces up to ``chunk_size`` with ``chunk_overlap``."""

    def __init__(
        self,
        separators: Optional[List[str]] = None,
        keep_separator: bool = False,
        chunk_size: int = 200,
        chunk_overlap: int = 100,
        length_function: Optional[Callable[[str], int]] = None,
    ) -> None:
        self.separators = separators or ["\n\n", "\n", " ", ""]
        self.keep_separator = keep_separator
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.length = length_function or len

    def split_text(self, text: str) -> List[str]:
        return self._split(text, self.separators)

    def _split(self, text: str, separators: List[str]) -> List[str]:
        final_chunks: List[str] = []
        separator = separators[-1]
        remaining = separators
        for i, candidate in enumerate(separators):
            if candidate == "" or candidate in text:
                separator = candidate
                remaining = separators[i + 1 :]
                break
        splits = self._split_on(text, separator)
        good: List[str] = []
        merge_sep = "" if self.keep_separator else separator
        for piece in splits:
            if self.length(piece) < self.chunk_size:
                good.append(piece)
            else:
                if good:
                    final_chunks.extend(self._merge(good, merge_sep))
                    good = []
                if not remaining:
                    final_chunks.append(piece)
                else:
                    final_chunks.extend(self._split(piece, remaining))
        if good:
            final_chunks.extend(self._merge(good, merge_sep))
        return final_chunks

    def _split_on(self, text: str, separator: str) -> List[str]:
        if separator == "":
            return [c for c in text]
        if self.keep_separator:
            parts = re.split(f"({re.escape(separator)})", text)
            out = [parts[i] + (parts[i + 1] if i + 1 < len(parts) else "")
                   for i in range(0, len(parts), 2)]
            return [p for p in out if p]
        return [p for p in text.split(separator) if p]

    def _merge(self, splits: List[str], separator: str) -> List[str]:
        docs: List[str] = []
        current: List[str] = []
        total = 0
        sep_len = self.length(separator)
        for piece in splits:
            piece_len = self.length(piece)
            if current and total + piece_len + sep_len > self.chunk_size:
                doc = separator.join(current).strip()
                if doc:
                    docs.append(doc)
                # pop from the left until within overlap
                while current and (
                    total > self.chunk_overlap
                    or (total + piece_len + sep_len > self.chunk_size and total > 0)
                ):
                    total -= self.length(current[0]) + sep_len
                    current.pop(0)
            current.append(piece)
            total += piece_len + sep_len
        doc = separator.join(current).strip()
        if doc:
            docs.append(doc)
        return docs


def _simple_token_length(text: str) -> int:
    """Token estimate stand-in for the reference's tiktoken cl100k_base
    (not bundled): whitespace/punctuation token count."""
    return max(1, len(re.findall(r"\w+|[^\w\s]", text)))


class TextSplitterAgent(SingleRecordProcessor):
    agent_type = "text-splitter"

    async def init(self, configuration: Dict[str, Any]) -> None:
        if configuration.get("splitter_type", "RecursiveCharacterTextSplitter") != (
            "RecursiveCharacterTextSplitter"
        ):
            raise ValueError("only RecursiveCharacterTextSplitter is supported")
        length_name = configuration.get("length_function", "cl100k_base")
        length_fn = len if length_name == "length" else _simple_token_length
        self.splitter = RecursiveCharacterTextSplitter(
            separators=configuration.get("separators", ["\n\n", "\n", " ", ""]),
            keep_separator=bool(configuration.get("keep_separator", False)),
            chunk_size=int(configuration.get("chunk_size", 200)),
            chunk_overlap=int(configuration.get("chunk_overlap", 100)),
            length_function=length_fn,
        )
        self._length = length_fn

    async def process_record(self, record: Record) -> List[Record]:
        text = record.value_as_text()
        chunks = self.splitter.split_text(text)
        out = []
        for chunk_id, chunk in enumerate(chunks):
            out.append(
                record.with_value(chunk)
                .with_header("chunk_id", str(chunk_id))
                .with_header("chunk_text_length", str(len(chunk)))
                .with_header("chunk_num_tokens", str(self._length(chunk)))
                .with_header("text_num_chunks", str(len(chunks)))
            )
        return out


# ---------------------------------------------------------------------- #
# document-to-json
# ---------------------------------------------------------------------- #
class DocumentToJsonAgent(SingleRecordProcessor):
    """Wrap the raw value into a JSON object field
    (``DocumentToJsonAgent.java:29``)."""

    agent_type = "document-to-json"

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.text_field = configuration.get("text-field", "text")
        self.copy_properties = bool(configuration.get("copy-properties", True))

    async def process_record(self, record: Record) -> List[Record]:
        payload: Dict[str, Any] = {self.text_field: record.value_as_text()}
        if self.copy_properties:
            for name, value in record.headers:
                payload[name] = value
        return [record.with_value(payload)]


# ---------------------------------------------------------------------- #
# text-normaliser
# ---------------------------------------------------------------------- #
class TextNormaliserAgent(SingleRecordProcessor):
    agent_type = "text-normaliser"

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.lowercase = bool(configuration.get("make-lowercase", True))
        self.trim_spaces = bool(configuration.get("trim-spaces", True))

    async def process_record(self, record: Record) -> List[Record]:
        text = record.value_as_text()
        if self.trim_spaces:
            text = re.sub(r"[ \t]+", " ", text)
            text = "\n".join(line.strip() for line in text.splitlines()).strip()
        if self.lowercase:
            text = text.lower()
        return [record.with_value(text)]


# ---------------------------------------------------------------------- #
# language detection
# ---------------------------------------------------------------------- #
_LANG_PROFILES = {
    # coarse stopword profiles; the reference uses the Lingua library
    "en": {"the", "and", "of", "to", "is", "in", "that", "it", "for", "was", "with", "are", "this", "you"},
    "es": {"el", "la", "de", "que", "y", "en", "los", "del", "las", "por", "un", "una", "es", "para"},
    "fr": {"le", "la", "de", "et", "les", "des", "est", "en", "un", "une", "du", "que", "pour", "dans"},
    "de": {"der", "die", "und", "das", "ist", "von", "den", "mit", "für", "auf", "des", "ein", "eine", "nicht"},
    "it": {"il", "la", "di", "che", "e", "un", "per", "una", "sono", "del", "non", "con", "le", "si"},
    "pt": {"o", "de", "que", "e", "do", "da", "em", "um", "para", "com", "não", "uma", "os", "no"},
}


def detect_language(text: str) -> str:
    words = set(re.findall(r"[\w']+", text.lower()))
    best, best_score = "unknown", 0
    for lang, profile in _LANG_PROFILES.items():
        score = len(words & profile)
        if score > best_score:
            best, best_score = lang, score
    return best if best_score >= 1 else "unknown"


class LanguageDetectorAgent(SingleRecordProcessor):
    """``LanguageDetectorAgent.java:27``: tag records with the detected
    language (property) so a ``when`` predicate can filter them."""

    agent_type = "language-detector"

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.property = configuration.get("property", "language")
        self.allowed = configuration.get("allowedLanguages", []) or []

    async def process_record(self, record: Record) -> List[Record]:
        language = detect_language(record.value_as_text())
        if self.allowed and language not in self.allowed:
            return []
        return [record.with_header(self.property, language)]


# ---------------------------------------------------------------------- #
# text extraction
# ---------------------------------------------------------------------- #
class _HTMLTextExtractor(html.parser.HTMLParser):
    def __init__(self) -> None:
        super().__init__()
        self.parts: List[str] = []
        self._skip = 0

    def handle_starttag(self, tag, attrs):
        if tag in ("script", "style"):
            self._skip += 1

    def handle_endtag(self, tag):
        if tag in ("script", "style") and self._skip:
            self._skip -= 1

    def handle_data(self, data):
        if not self._skip and data.strip():
            self.parts.append(data.strip())


class TextExtractorAgent(SingleRecordProcessor):
    """Dependency-free extraction for text-like formats (txt/html/json/md).

    The reference uses Apache Tika (``TikaTextExtractorAgent.java:35``) with
    tesseract/libreoffice in the pod image; binary formats (PDF, DOCX) are
    out of scope for this build and produce a clear error instead of noise.
    """

    agent_type = "text-extractor"

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.configuration = configuration

    async def process_record(self, record: Record) -> List[Record]:
        value = record.value
        if isinstance(value, bytes):
            if value[:4] == b"%PDF":
                raise ValueError(
                    "PDF extraction is not supported in this build "
                    "(reference uses Apache Tika); extract upstream"
                )
            value = value.decode("utf-8", errors="replace")
        text = value if isinstance(value, str) else json.dumps(value, default=str)
        lowered = text.lstrip().lower()
        if lowered.startswith(("<!doctype html", "<html")):
            extractor = _HTMLTextExtractor()
            extractor.feed(text)
            text = "\n".join(extractor.parts)
            text = html.unescape(text)
        text = unicodedata.normalize("NFC", text)
        return [record.with_value(text)]
