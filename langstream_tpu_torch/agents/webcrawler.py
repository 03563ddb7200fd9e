"""Web crawler source with checkpointed status.

Equivalent of the reference's ``langstream-agent-webcrawler``
(``WebCrawlerSource.java:62`` + ``crawler/WebCrawler.java:51``): crawl seed
URLs within allowed domains, respect robots.txt, emit one record per page,
and checkpoint crawl status (visited set + frontier) so a restarted agent
resumes where it stopped — the reference persists to S3 or the agent disk
(``WebCrawlerSource.java:381-440``); here the agent's persistent state
directory (``StatusStorage`` contract).

The port's own copy of ``langstream_tpu/agents/webcrawler.py``: pages and
robots.txt come through the port's HTTP client (``agents/http_client.py``)
where the JAX package uses ``aiohttp``, and links are read with the
standard library's ``html.parser`` where it uses BeautifulSoup's
``html.parser`` builder: every ``<a href>`` in document order, as
``find_all("a", href=True)`` yields them.
"""

from __future__ import annotations

import asyncio
import html.parser
import json
import logging
import os
import urllib.parse
import urllib.robotparser
from typing import Any, Dict, List, Optional, Set

from langstream_tpu_torch.agents import http_client
from langstream_tpu_torch.api.agent import AgentSource
from langstream_tpu_torch.api.records import Record

logger = logging.getLogger(__name__)


class WebCrawlerSource(AgentSource):
    agent_type = "webcrawler-source"

    async def init(self, configuration: Dict[str, Any]) -> None:
        self.seed_urls: List[str] = list(configuration.get("seed-urls", []))
        self.allowed_domains: List[str] = list(configuration.get("allowed-domains", []))
        self.forbidden_paths: List[str] = list(configuration.get("forbidden-paths", []))
        self.max_urls = int(configuration.get("max-urls", 1000))
        self.min_time_between_requests = (
            float(configuration.get("min-time-between-requests", 500)) / 1000.0
        )
        self.user_agent = configuration.get("user-agent", "langstream-tpu-crawler")
        self.handle_robots = bool(configuration.get("handle-robots-file", True))
        self.max_depth = int(configuration.get("max-depth", 50))
        self._frontier: List[Dict[str, Any]] = []
        self._visited: Set[str] = set()
        self._robots: Dict[str, urllib.robotparser.RobotFileParser] = {}
        self._headers = {"User-Agent": self.user_agent}
        self._status_path: Optional[str] = None

    async def start(self) -> None:
        state_dir = self.context.persistent_state_directory()
        if state_dir:
            self._status_path = os.path.join(state_dir, "webcrawler.status.json")
            self._load_status()
        if not self._frontier and not self._visited:
            self._frontier = [{"url": url, "depth": 0} for url in self.seed_urls]

    async def close(self) -> None:
        self._save_status()

    # -- status checkpointing (StatusStorage contract) ------------------ #
    def _load_status(self) -> None:
        if self._status_path and os.path.exists(self._status_path):
            with open(self._status_path, "r", encoding="utf-8") as handle:
                status = json.load(handle)
            self._visited = set(status.get("visited", []))
            self._frontier = list(status.get("frontier", []))
            logger.info(
                "resumed crawl: %d visited, %d queued",
                len(self._visited),
                len(self._frontier),
            )

    def _save_status(self) -> None:
        if not self._status_path:
            return
        with open(self._status_path, "w", encoding="utf-8") as handle:
            json.dump(
                {"visited": sorted(self._visited), "frontier": self._frontier},
                handle,
            )

    # -- crawling -------------------------------------------------------- #
    def _allowed(self, url: str) -> bool:
        parsed = urllib.parse.urlparse(url)
        if parsed.scheme not in ("http", "https"):
            return False
        if self.allowed_domains and not any(
            parsed.netloc == d or parsed.netloc.endswith("." + d)
            or url.startswith(d)
            for d in self.allowed_domains
        ):
            return False
        if any(parsed.path.startswith(p) for p in self.forbidden_paths):
            return False
        return True

    async def _robots_allows(self, url: str) -> bool:
        if not self.handle_robots:
            return True
        parsed = urllib.parse.urlparse(url)
        base = f"{parsed.scheme}://{parsed.netloc}"
        parser = self._robots.get(base)
        if parser is None:
            parser = urllib.robotparser.RobotFileParser()
            try:
                response = await http_client.request(
                    "GET", base + "/robots.txt", headers=self._headers, timeout=10
                )
                if response.status == 200:
                    parser.parse((await response.text()).splitlines())
                else:
                    parser.allow_all = True
            except Exception:  # noqa: BLE001 — no robots file = allow
                parser.allow_all = True
            self._robots[base] = parser
        return parser.can_fetch(self.user_agent, url)

    def _extract_links(self, base_url: str, html_text: str) -> List[str]:
        anchors = _Anchors()
        anchors.feed(html_text)
        anchors.close()
        links = []
        for href in anchors.hrefs:
            href = urllib.parse.urljoin(base_url, href)
            href = urllib.parse.urldefrag(href).url
            links.append(href)
        return links

    async def read(self, max_records: int = 100) -> List[Record]:
        if not self._frontier or len(self._visited) >= self.max_urls:
            await asyncio.sleep(1.0)
            return []
        entry = self._frontier.pop(0)
        url, depth = entry["url"], int(entry.get("depth", 0))
        if url in self._visited or not self._allowed(url):
            return []
        self._visited.add(url)
        if not await self._robots_allows(url):
            return []
        await asyncio.sleep(self.min_time_between_requests)
        try:
            response = await http_client.request(
                "GET", url, headers=self._headers, timeout=30
            )
            if response.status != 200:
                logger.info("skipping %s: HTTP %d", url, response.status)
                return []
            content_type = response.headers.get("Content-Type", "")
            body = await response.read()
        except Exception as error:  # noqa: BLE001 — crawl on
            logger.warning("error fetching %s: %s", url, error)
            return []
        if "html" in content_type and depth < self.max_depth:
            try:
                links = self._extract_links(url, body.decode("utf-8", "replace"))
                for link in links:
                    if link not in self._visited and self._allowed(link):
                        self._frontier.append({"url": link, "depth": depth + 1})
            except Exception:  # noqa: BLE001
                pass
        self._save_status()
        return [
            Record(
                value=body,
                key=url,
                headers=(("url", url), ("content_type", content_type)),
            )
        ]

    async def commit(self, records: List[Record]) -> None:
        self._save_status()


class _Anchors(html.parser.HTMLParser):
    """The ``href`` of every ``<a>`` that has one, in document order (the
    last ``href`` of a tag that repeats it, as BeautifulSoup keeps)."""

    def __init__(self) -> None:
        super().__init__(convert_charrefs=True)
        self.hrefs: List[str] = []

    def _anchor(self, tag: str, attrs) -> None:
        if tag == "a":
            href = dict(attrs).get("href")
            if href is not None:
                self.hrefs.append(href)

    handle_starttag = _anchor
    handle_startendtag = _anchor
