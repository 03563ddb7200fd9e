"""Typed agent-configuration model: docs + validation.

The counterpart of the reference's annotation-driven config
system (``@AgentConfig``/``@ConfigProperty`` doc model,
langstream-api/src/main/java/ai/langstream/api/doc/ConfigProperty.java,
validated reflectively by
langstream-core/src/main/java/ai/langstream/impl/uti/ClassConfigValidator.java:60
and surfaced as JSON for CLI docs). Here the declarations are plain
dataclasses in one table — no reflection — consumed by:

- the **compiler** (``compiler.planner``) to reject bad agent configs at
  plan time with actionable errors, and
- the **CLI** ``docs`` command to print per-agent reference docs (JSON
  or text).

Validation is deliberately advisory-strict: unknown keys are errors for
documented agents (matching ClassConfigValidator's default), but agent
types with no doc entry pass through untouched (custom/python agents).

The port's own copy of ``langstream_tpu/model/docs.py``: the same table,
so that the port plans what JAX plans and rejects what it rejects. A
``camel-source``'s URI is judged at plan time by
``agents/camel.py``'s ``validate_component_uri``, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

def _intish(v: Any) -> bool:
    # numeric STRINGS pass: placeholder defaults (`${globals.x:-256}`)
    # always substitute as strings, and the reference's Jackson-backed
    # validation (ClassConfigValidator.java:60) coerces them the same way
    if isinstance(v, str):
        try:
            int(v)
            return True
        except ValueError:
            return False
    return isinstance(v, int) and not isinstance(v, bool)


def _numberish(v: Any) -> bool:
    if isinstance(v, str):
        try:
            float(v)
            return True
        except ValueError:
            return False
    return isinstance(v, (int, float)) and not isinstance(v, bool)


_TYPE_CHECKS = {
    "string": lambda v: isinstance(v, str),
    # the empty string is NOT a boolean: a blank placeholder
    # substitution must fall back to the property default at the
    # validation layer, not pass through with ambiguous truthiness
    "boolean": lambda v: isinstance(v, bool) or (
        isinstance(v, str) and v.lower() in ("true", "false", "1", "0")
    ),
    "integer": _intish,
    "number": _numberish,
    "object": lambda v: isinstance(v, dict),
    "list": lambda v: isinstance(v, (list, tuple)),
    "any": lambda v: True,
}


@dataclasses.dataclass(frozen=True)
class ConfigProperty:
    name: str
    type: str = "string"           # string|boolean|integer|number|object|list|any
    description: str = ""
    required: bool = False
    default: Any = None
    choices: Optional[Tuple[str, ...]] = None

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "name": self.name,
            "type": self.type,
            "description": self.description,
            "required": self.required,
        }
        if self.default is not None:
            out["default"] = self.default
        if self.choices:
            out["choices"] = list(self.choices)
        return out


@dataclasses.dataclass(frozen=True)
class AgentDoc:
    agent_type: str
    description: str
    properties: Tuple[ConfigProperty, ...] = ()
    category: str = "processor"    # source|processor|sink|service
    allow_unknown: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "type": self.agent_type,
            "category": self.category,
            "description": self.description,
            "properties": [p.to_dict() for p in self.properties],
        }


_P = ConfigProperty
_DOCS: Dict[str, AgentDoc] = {}


def register_doc(doc: AgentDoc) -> None:
    _DOCS[doc.agent_type] = doc


def get_doc(agent_type: str) -> Optional[AgentDoc]:
    return _DOCS.get(agent_type)


def all_docs() -> Dict[str, AgentDoc]:
    return dict(_DOCS)


def generate_docs_model() -> Dict[str, Any]:
    """Full JSON doc model (reference: the CLI's agent doc JSON)."""
    return {name: doc.to_dict() for name, doc in sorted(_DOCS.items())}


def validate_agent_config(
    agent_type: str, configuration: Dict[str, Any]
) -> List[str]:
    """Return a list of human-actionable errors ([] = valid). Unknown
    agent types validate as OK (custom agents document themselves)."""
    doc = _DOCS.get(agent_type)
    if doc is None:
        return []
    errors: List[str] = []
    by_name = {p.name: p for p in doc.properties}
    for prop in doc.properties:
        if prop.required and configuration.get(prop.name) is None:
            errors.append(
                f"{agent_type}: missing required property '{prop.name}'"
            )
    for key, value in (configuration or {}).items():
        prop = by_name.get(key)
        if prop is None:
            if not doc.allow_unknown:
                known = ", ".join(sorted(by_name)) or "(none)"
                errors.append(
                    f"{agent_type}: unknown property '{key}' "
                    f"(known: {known})"
                )
            continue
        if value is None:
            continue
        if value == "" and prop.type != "string":
            # "" is not a valid boolean/number/list literal (ADVICE r4),
            # and consumers read `config.get(key, default)` — a PRESENT
            # blank key would bypass the default and crash (int(""))
            # or silently flip (bool("")) at runtime. Fail at plan time
            # with the fix spelled out.
            errors.append(
                f"{agent_type}: property '{key}' is blank "
                f"(placeholder substituted to \"\") but expects "
                f"{prop.type} — give the placeholder a non-blank "
                f"default (`${{globals.x:-42}}`) or omit the key"
            )
            continue
        check = _TYPE_CHECKS.get(prop.type, _TYPE_CHECKS["any"])
        if not check(value):
            errors.append(
                f"{agent_type}: property '{key}' expects {prop.type}, "
                f"got {type(value).__name__}"
            )
        if prop.choices and isinstance(value, str) and value not in prop.choices:
            errors.append(
                f"{agent_type}: property '{key}' must be one of "
                f"{list(prop.choices)}, got {value!r}"
            )
    return errors


# ---------------------------------------------------------------------- #
# built-in agent docs
# ---------------------------------------------------------------------- #
_WHEN = _P("when", "string", "JSTL-style predicate; the step runs only on matching records")

for doc in [
    # --- GenAI toolkit steps (reference: GenAIToolKitFunctionAgentProvider
    # STEP_TYPES, impl/agents/ai/GenAIToolKitFunctionAgentProvider.java:53-74)
    AgentDoc("drop-fields", "Drop fields from the record", (
        _P("fields", "list", "field names to drop", required=True),
        _P("part", "string", "restrict to 'key' or 'value'", choices=("key", "value")),
        _WHEN,
    )),
    AgentDoc("merge-key-value", "Merge the key fields into the value", (_WHEN,)),
    AgentDoc("unwrap-key-value", "Replace the record with its key or value", (
        _P("unwrapKey", "boolean", "unwrap the key instead of the value", default=False),
        _WHEN,
    )),
    AgentDoc("cast", "Cast key/value to a schema type", (
        _P("schema-type", "string", "target schema type", required=True),
        _P("part", "string", "'key' or 'value'", choices=("key", "value")),
        _WHEN,
    )),
    AgentDoc("flatten", "Flatten nested structures into top-level fields", (
        _P("delimiter", "string", "separator for flattened names", default="_"),
        _P("part", "string", "'key' or 'value'", choices=("key", "value")),
        _WHEN,
    )),
    AgentDoc("drop", "Drop the whole record", (_WHEN,)),
    AgentDoc("compute", "Compute new fields with expressions", (
        _P("fields", "list", "list of {name, expression, type, optional}", required=True),
        _WHEN,
    )),
    AgentDoc("compute-ai-embeddings", "Compute embeddings for a text field", (
        _P("model", "string", "embeddings model name or checkpoint path"),
        _P("text", "string", "template of the text to embed", required=True),
        _P("embeddings-field", "string", "output field", required=True),
        _P("batch-size", "integer", "micro-batch size", default=10),
        _P("flush-interval", "integer", "max ms to hold a partial batch", default=0),
        _P("concurrency", "integer", "parallel in-flight batches", default=4),
        _P("ai-service", "string", "resource name of the AI service"),
        _WHEN,
    )),
    AgentDoc("query", "Query a datasource into a field", (
        _P("datasource", "string", "datasource resource name", required=True),
        _P("query", "string", "SQL/query with ? placeholders", required=True),
        _P("fields", "list", "expressions bound to the placeholders"),
        _P("output-field", "string", "where results land", required=True),
        _P("only-first", "boolean", "unwrap single row", default=False),
        _P("mode", "string", "query returns rows, execute mutates",
           default="query", choices=("query", "execute")),
        _WHEN,
    )),
    AgentDoc("ai-chat-completions", "Chat completion via the configured model service", (
        _P("model", "string", "model name"),
        _P("messages", "list", "chat messages with mustache templates", required=True),
        _P("completion-field", "string", "output field for the final text"),
        _P("log-field", "string", "field for the rendered prompt"),
        _P("stream-to-topic", "string", "topic for streamed chunks"),
        _P("stream-response-completion-field", "string", "field in streamed records"),
        _P("min-chunks-per-message", "integer", "chunk batching ramp", default=20),
        _P("temperature", "number", "sampling temperature"),
        _P("max-tokens", "integer", "max new tokens"),
        _P("top-p", "number", "nucleus sampling"),
        _P("top-k", "integer", "top-k sampling"),
        _P("stop", "list", "stop strings: generation ends at the first match"),
        _P("presence-penalty", "number", "flat logit penalty on generated tokens"),
        _P("frequency-penalty", "number", "per-count logit penalty on generated tokens"),
        _P("seed", "integer", "per-request sampling seed (reproducible sampling)"),
        _P("logit-bias", "object", "token id -> additive logit adjustment"),
        _P("session-field", "string", "expression for KV-cache session affinity"),
        _P("ai-service", "string", "resource name of the AI service"),
        _P("logprobs", "boolean", "emit per-token text + logprobs", default=False),
        _P("logprobs-field", "string", "field for token logprobs", default="value.logprobs"),
        _P("tokens-field", "string", "field for token text pieces", default="value.tokens"),
        _WHEN,
    )),
    AgentDoc("ai-text-completions", "Raw text completion via the configured model", (
        _P("model", "string", "model name"),
        _P("prompt", "list", "prompt template(s)", required=True),
        _P("completion-field", "string", "output field"),
        _P("log-field", "string", "field for the rendered prompt"),
        _P("stream-to-topic", "string", "topic for streamed chunks"),
        _P("stream-response-completion-field", "string", "field in streamed records"),
        _P("min-chunks-per-message", "integer", "chunk batching ramp", default=20),
        _P("temperature", "number", "sampling temperature"),
        _P("max-tokens", "integer", "max new tokens"),
        _P("top-p", "number", "nucleus sampling"),
        _P("top-k", "integer", "top-k sampling"),
        _P("stop", "list", "stop strings: generation ends at the first match"),
        _P("presence-penalty", "number", "flat logit penalty on generated tokens"),
        _P("frequency-penalty", "number", "per-count logit penalty on generated tokens"),
        _P("seed", "integer", "per-request sampling seed (reproducible sampling)"),
        _P("logit-bias", "object", "token id -> additive logit adjustment"),
        _P("ai-service", "string", "resource name of the AI service"),
        _P("logprobs", "boolean", "emit per-token text + logprobs", default=False),
        _P("logprobs-field", "string", "field for token logprobs", default="value.logprobs"),
        _P("tokens-field", "string", "field for token text pieces", default="value.tokens"),
        _WHEN,
    )),
    # --- text processing (reference: langstream-agents-text-processing)
    AgentDoc("text-extractor", "Extract plain text from documents", (_WHEN,)),
    AgentDoc("text-normaliser", "Normalise text (case, whitespace)", (
        _P("make-lowercase", "boolean", "lowercase the text", default=True),
        _P("trim-spaces", "boolean", "collapse whitespace", default=True),
    )),
    AgentDoc("text-splitter", "Split text into chunks for embeddings", (
        _P("splitter_type", "string", "splitting algorithm", default="RecursiveCharacterTextSplitter"),
        _P("separators", "list", "split separators in priority order"),
        _P("chunk_size", "integer", "max chunk length", default=200),
        _P("chunk_overlap", "integer", "overlap between chunks", default=100),
        _P("keep_separator", "boolean", "keep the separator text", default=False),
        _P("length_function", "string", "cl100k_base or a python len fn", default="cl100k_base"),
    )),
    AgentDoc("language-detector", "Detect the text language into a field", (
        _P("property", "string", "output property name", default="language"),
        _P("allowedLanguages", "list", "drop records outside this set"),
    )),
    AgentDoc("document-to-json", "Wrap raw text into a JSON document", (
        _P("text-field", "string", "field name for the text", default="text"),
        _P("copy-properties", "boolean", "copy record headers", default=True),
    )),
    # --- flow control (reference: langstream-agents-flow-control)
    AgentDoc("dispatch", "Route records to topics by condition", (
        _P("routes", "list", "list of {when, destination, action}", required=True),
    )),
    AgentDoc("timer-source", "Emit a record every interval", (
        _P("period-seconds", "integer", "emission period", default=60),
        _P("fields", "list", "computed fields for the emitted record"),
    ), category="source"),
    AgentDoc("trigger-event", "Emit an event record when a condition holds", (
        _P("destination", "string", "topic to send the event to"),
        _P("when", "string", "trigger condition", default="true"),
        _P("fields", "list", "computed fields of the event"),
        _P("continue-processing", "boolean", "also forward the original", default=True),
    )),
    AgentDoc("log-event", "Log matching records (debugging)", (
        _P("when", "string", "condition", default="true"),
        _P("message", "string", "log line prefix", default="log-event"),
        _P("fields", "list", "computed fields to log"),
    )),
    # --- sources / sinks
    AgentDoc("webcrawler-source", "Crawl websites into records", (
        _P("seed-urls", "list", "starting URLs", required=True),
        _P("allowed-domains", "list", "crawl boundary"),
        _P("forbidden-paths", "list", "paths to skip"),
        _P("max-urls", "integer", "crawl budget", default=1000),
        _P("max-depth", "integer", "link depth budget", default=50),
        _P("min-time-between-requests", "integer", "politeness delay ms", default=500),
        _P("reindex-interval-seconds", "integer", "recrawl period", default=86400),
        _P("user-agent", "string", "crawler user agent"),
        _P("handle-robots-file", "boolean", "honor robots.txt", default=True),
        _P("state-storage", "string", "checkpoint backend", choices=("disk", "s3")),
        _P("bucketName", "string", "s3 bucket for state"),
        _P("endpoint", "string", "s3 endpoint for state"),
        _P("access-key", "string", "s3 access key"),
        _P("secret-key", "string", "s3 secret key"),
        _P("region", "string", "s3 region"),
    ), category="source", allow_unknown=True),
    AgentDoc("s3-source", "Read objects from an S3 bucket", (
        _P("bucketName", "string", "bucket to read", default="langstream-source"),
        _P("endpoint", "string", "s3 endpoint"),
        _P("access-key", "string", "access key"),
        _P("secret-key", "string", "secret key"),
        _P("region", "string", "region"),
        _P("file-extensions", "string", "comma-separated extension filter"),
        _P("idle-time", "integer", "poll period seconds", default=5),
        _P("delete-objects", "boolean", "delete after processing", default=True),
    ), category="source"),
    AgentDoc("azure-blob-storage-source", "Read blobs from Azure storage", (
        _P("container", "string", "container name", default="langstream-azure-source"),
        _P("endpoint", "string", "storage endpoint (or derive from account name)"),
        _P("sas-token", "string", "SAS token"),
        _P("storage-account-name", "string", "account name"),
        _P("storage-account-key", "string", "account key"),
        _P("storage-account-connection-string", "string", "connection string"),
        _P("file-extensions", "string", "extension filter"),
        _P("idle-time", "integer", "poll period seconds", default=5),
        _P("delete-objects", "boolean", "delete after processing", default=True),
    ), category="source"),
    AgentDoc("file-source", "Read files from a local directory", (
        _P("path", "string", "directory to read", required=True),
        _P("file-extensions", "string", "extension filter"),
        _P("idle-time", "integer", "poll period seconds", default=5),
        _P("delete-objects", "boolean", "delete after processing", default=False),
    ), category="source"),
    AgentDoc("vector-db-sink", "Write embeddings/documents to a vector store", (
        _P("datasource", "string", "vector database resource", required=True),
    ), category="sink", allow_unknown=True),
    AgentDoc("query-vector-db", "Query a vector store into a field", (
        _P("datasource", "string", "vector database resource", required=True),
        _P("query", "string", "query with ? placeholders", required=True),
        _P("fields", "list", "expressions bound to placeholders"),
        _P("output-field", "string", "result field", required=True),
        _P("only-first", "boolean", "unwrap single result", default=False),
        _WHEN,
    )),
    AgentDoc("re-rank", "Re-rank retrieved documents (MMR)", (
        _P("field", "string", "field holding candidates", default="value.query-result"),
        _P("output-field", "string", "ranked output field (defaults to field)"),
        _P("query-embeddings", "string", "query vector expression",
           default="value.question_embeddings"),
        _P("vector-field", "string", "candidate vector key", default="vector"),
        _P("algorithm", "string", "ranking algorithm", default="MMR", choices=("MMR", "none")),
        _P("lambda", "number", "MMR relevance/diversity balance", default=0.5),
        _P("max", "integer", "results to keep", default=10),
    )),
    AgentDoc("http-request", "Call an HTTP endpoint per record", (
        _P("url", "string", "target URL template", required=True),
        _P("output-field", "string", "response field", default="value"),
        _P("method", "string", "HTTP method", default="GET"),
        _P("headers", "object", "request headers"),
        _P("query-string", "object", "query params (templated)"),
        _P("body", "string", "request body template"),
        _P("allow-redirects", "boolean", "follow redirects", default=True),
        _P("handle-cookies", "boolean", "keep a cookie jar", default=True),
    )),
    AgentDoc("python-source", "User Python source", (
        _P("className", "string", "python class path", required=True),
        _P("isolation", "string", "auto (process when the app ships python/lib deps, else in-process), none, or process (crash-isolated child)", default="auto"),
    ), category="source", allow_unknown=True),
    AgentDoc("python-processor", "User Python processor", (
        _P("className", "string", "python class path", required=True),
        _P("isolation", "string", "auto (process when the app ships python/lib deps, else in-process), none, or process (crash-isolated child)", default="auto"),
    ), allow_unknown=True),
    AgentDoc("python-sink", "User Python sink", (
        _P("className", "string", "python class path", required=True),
        _P("isolation", "string", "auto (process when the app ships python/lib deps, else in-process), none, or process (crash-isolated child)", default="auto"),
    ), category="sink", allow_unknown=True),
    AgentDoc("python-service", "User Python service", (
        _P("className", "string", "python class path", required=True),
        _P("isolation", "string", "auto (process when the app ships python/lib deps, else in-process), none, or process (crash-isolated child)", default="auto"),
    ), category="service", allow_unknown=True),
    AgentDoc("flare-controller", "FLARE iterative-retrieval loop controller", (
        _P("tokens-field", "string", "field with completion tokens", default="value.tokens"),
        _P("logprobs-field", "string", "field with token logprobs", default="value.logprobs"),
        _P("loop-topic", "string", "topic to send low-confidence records to", required=True),
        _P("retrieve-documents-field", "string", "field receiving the spans",
           default="value.documents_to_retrieve"),
        _P("min-prob", "number", "low-confidence probability threshold", default=0.2),
        _P("min-token-gap", "integer", "span merge distance", default=5),
        _P("num-pad-tokens", "integer", "span padding", default=2),
        _P("max-iterations", "integer", "loop bound", default=10),
        _P("num-iterations-field", "string", "iteration counter field",
           default="value.flare_iterations"),
    )),
    AgentDoc("langserve-invoke", "Call a LangServe runnable (invoke or stream)", (
        _P("url", "string", "LangServe endpoint (/invoke or /stream)", required=True),
        _P("fields", "list", "input fields: {name, expression}"),
        _P("output-field", "string", "final output field", default="value"),
        _P("content-field", "string", "chunk content field", default="value"),
        _P("stream-to-topic", "string", "topic for streamed chunks"),
        _P("min-chunks-per-message", "integer", "chunk batching ramp", default=20),
        _P("headers", "object", "extra HTTP headers"),
    )),
    AgentDoc("camel-source", "Consume a Camel endpoint URI (native "
             "timer/file/http(s)/kafka/netty-http/aws2-s3/"
             "azure-storage-blob/pulsar mappings; plugin schemes or "
             "exec-source for the rest)", (
        _P("component-uri", "string",
           "Camel endpoint, e.g. timer:tick?period=1000", required=True),
        _P("component-options", "object", "extra endpoint parameters"),
        _P("key-header", "string", "header whose value becomes the key"),
        _P("max-buffered-records", "integer", "read batch cap", default=100),
        _P("expect-plugin-scheme", "boolean",
           "defer unknown-scheme validation to runtime (a plugin "
           "package registers the scheme when the pod loads)",
           default=False),
    ), category="source"),
    AgentDoc("exec-source", "Run a command; stdout lines become records", (
        _P("command", "string", "command line to run", required=True),
        _P("parse-json", "boolean", "JSON-decode each line", default=True),
        _P("restart-seconds", "number", "restart backoff", default=5),
        _P("max-restarts", "integer", "0 = restart forever", default=0),
    ), category="source"),
    AgentDoc("exec-sink", "Run a command; records stream to its stdin", (
        _P("command", "string", "command line to run", required=True),
    ), category="sink"),
    AgentDoc("kafka-connect-source", "Run a Kafka Connect source connector", (
        _P("connect-url", "string", "Connect worker REST URL", required=True),
        _P("connector-name", "string", "connector name", required=True),
        _P("connector-config", "object", "raw Connect connector config",
           required=True),
        _P("topic", "string", "Kafka topic the connector writes",
           required=True),
        _P("bootstrapServers", "string", "Kafka bootstrap for the data topic"),
        _P("delete-on-close", "boolean", "delete the connector on shutdown",
           default=False),
        _P("rebalance-timeout", "number",
           "seconds to retry 409s while the worker group rebalances",
           default=30),
        _P("restart-failed-tasks", "boolean",
           "auto-restart FAILED connector tasks via the REST API",
           default=True),
        _P("health-check-interval", "number",
           "seconds between connector status polls (0 disables)",
           default=30),
    ), category="source"),
    AgentDoc("kafka-connect-sink", "Run a Kafka Connect sink connector", (
        _P("connect-url", "string", "Connect worker REST URL", required=True),
        _P("connector-name", "string", "connector name", required=True),
        _P("connector-config", "object", "raw Connect connector config",
           required=True),
        _P("topic", "string", "staging Kafka topic the connector consumes",
           required=True),
        _P("bootstrapServers", "string", "Kafka bootstrap for the data topic"),
        _P("delete-on-close", "boolean", "delete the connector on shutdown",
           default=False),
        _P("rebalance-timeout", "number",
           "seconds to retry 409s while the worker group rebalances",
           default=30),
        _P("restart-failed-tasks", "boolean",
           "auto-restart FAILED connector tasks via the REST API",
           default=True),
        _P("health-check-interval", "number",
           "seconds between connector status polls (0 disables)",
           default=30),
    ), category="sink"),
    AgentDoc("identity", "Pass records through unchanged", ()),
    AgentDoc("ai-tools", "GenAI toolkit executor (compiled steps)", (),
             allow_unknown=True),
    AgentDoc("composite-agent", "Fused pipeline of agents in one pod", (),
             allow_unknown=True),
]:
    register_doc(doc)
