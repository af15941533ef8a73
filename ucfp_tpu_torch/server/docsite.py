"""Docs site: render docs/*.md as HTML pages at /docs[/{page}].

The reference web app ships a documentation site (10 markdown pages in
web/src/lib/docs rendered by the SvelteKit app). This serves the same
content-from-markdown pattern with zero dependencies: a small,
escape-first markdown renderer covering the constructs the doc set uses
(headings, fenced code, inline code, bold/italic, links, tables,
lists, blockquotes, hr). All input is HTML-escaped BEFORE any transform
— the renderer emits only tags it generates itself.

Copied from ucfp_tpu/server/docsite.py; only its imports differ.
"""

from __future__ import annotations

import html
import re
from pathlib import Path
from typing import Optional

DOCS_DIR = Path(__file__).resolve().parents[2] / "docs"

# display order + titles for the index (mirrors the reference's
# category ordering); pages found on disk but not listed are appended
_ORDER = [
    ("getting-started", "Getting started"),
    ("authentication", "Authentication"),
    ("api-reference", "API reference"),
    ("api-reference-text", "API reference — text"),
    ("api-reference-image", "API reference — image"),
    ("api-reference-audio", "API reference — audio"),
    ("error-codes", "Error codes"),
    ("rate-limits", "Rate limits"),
    ("examples", "Examples"),
    ("sdk-python", "SDK — Python"),
    ("sdk-javascript", "SDK — JavaScript"),
    ("ARCHITECTURE", "Architecture"),
    ("DEPLOY", "Deployment"),
]

_NAME_RE = re.compile(r"^[A-Za-z0-9_-]+$")

_STYLE = """
 body{font-family:system-ui,sans-serif;margin:0;background:#0e1117;color:#e6edf3}
 header{padding:12px 20px;background:#161b22;display:flex;gap:16px;align-items:baseline}
 header h1{font-size:16px;margin:0}
 header a{color:#58a6ff;text-decoration:none;font-size:13px}
 main{max-width:880px;margin:0 auto;padding:20px 20px 60px}
 a{color:#58a6ff}
 h1,h2,h3{border-bottom:1px solid #21262d;padding-bottom:4px}
 code{background:#161b22;padding:1px 5px;border-radius:4px;
   font-family:ui-monospace,monospace;font-size:13px}
 pre{background:#161b22;border:1px solid #30363d;border-radius:8px;
   padding:12px;overflow-x:auto}
 pre code{background:none;padding:0}
 table{border-collapse:collapse;margin:12px 0}
 th,td{border:1px solid #30363d;padding:6px 10px;text-align:left;font-size:14px}
 th{background:#161b22}
 blockquote{border-left:3px solid #30363d;margin:0;padding:2px 14px;color:#9da7b3}
 hr{border:0;border-top:1px solid #21262d}
 li{margin:3px 0}
 .toc a{display:block;padding:6px 0}
"""


def _inline(text: str) -> str:
    """Inline markdown on already-escaped text: code, bold, italics,
    links. Code spans are substituted first and restored last so their
    contents are never touched by the other rules."""
    spans: list[str] = []

    def stash(m: re.Match) -> str:
        spans.append(m.group(1))
        return f"\x00{len(spans) - 1}\x00"

    text = re.sub(r"`([^`]+)`", stash, text)
    text = re.sub(r"\*\*([^*]+)\*\*", r"<strong>\1</strong>", text)
    text = re.sub(r"(?<![\w*])\*([^*\s][^*]*)\*(?![\w*])", r"<em>\1</em>", text)

    def link(m: re.Match) -> str:
        label, href = m.group(1), m.group(2)
        # internal .md links become /docs/<page> routes
        if href.endswith(".md") and "//" not in href:
            href = "/docs/" + href[:-3].lstrip("./")
        href = href.replace('"', "%22")
        return f'<a href="{href}">{label}</a>'

    text = re.sub(r"\[([^\]]+)\]\(([^)\s]+)\)", link, text)
    text = re.sub(
        r"\x00(\d+)\x00", lambda m: f"<code>{spans[int(m.group(1))]}</code>", text
    )
    return text


def render_markdown(md: str) -> str:
    """Markdown → HTML for the subset the doc pages use."""
    # NUL bytes collide with _inline's code-span placeholder scheme
    # (\x00N\x00) and are never legitimate markdown
    md = md.replace("\x00", "")
    out: list[str] = []
    lines = md.split("\n")
    i = 0
    in_list: Optional[str] = None  # "ul" | "ol"
    para: list[str] = []

    def flush_para() -> None:
        if para:
            out.append(f"<p>{_inline(' '.join(para))}</p>")
            para.clear()

    def close_list() -> None:
        nonlocal in_list
        if in_list:
            out.append(f"</{in_list}>")
            in_list = None

    while i < len(lines):
        raw = lines[i]
        line = html.escape(raw, quote=False)

        # fenced code block
        if raw.startswith("```"):
            flush_para()
            close_list()
            code: list[str] = []
            i += 1
            while i < len(lines) and not lines[i].startswith("```"):
                code.append(html.escape(lines[i], quote=False))
                i += 1
            out.append("<pre><code>" + "\n".join(code) + "</code></pre>")
            i += 1
            continue

        # table: header row + |---| separator
        if (
            raw.startswith("|")
            and i + 1 < len(lines)
            and re.match(r"^\|[\s:|-]+\|?\s*$", lines[i + 1])
        ):
            flush_para()
            close_list()

            def cells(s: str) -> list[str]:
                return [c.strip() for c in s.strip().strip("|").split("|")]

            head = cells(html.escape(lines[i], quote=False))
            out.append("<table><thead><tr>")
            out.extend(f"<th>{_inline(c)}</th>" for c in head)
            out.append("</tr></thead><tbody>")
            i += 2
            while i < len(lines) and lines[i].startswith("|"):
                out.append("<tr>")
                out.extend(
                    f"<td>{_inline(c)}</td>"
                    for c in cells(html.escape(lines[i], quote=False))
                )
                out.append("</tr>")
                i += 1
            out.append("</tbody></table>")
            continue

        m = re.match(r"^(#{1,4})\s+(.*)$", line)
        if m:
            flush_para()
            close_list()
            n = len(m.group(1))
            out.append(f"<h{n}>{_inline(m.group(2))}</h{n}>")
        elif re.match(r"^\s*([-*])\s+", raw):
            flush_para()
            if in_list != "ul":
                close_list()
                out.append("<ul>")
                in_list = "ul"
            item = re.sub(r"^\s*[-*]\s+", "", line)
            out.append(f"<li>{_inline(item)}</li>")
        elif re.match(r"^\s*\d+\.\s+", raw):
            flush_para()
            if in_list != "ol":
                close_list()
                out.append("<ol>")
                in_list = "ol"
            item = re.sub(r"^\s*\d+\.\s+", "", line)
            out.append(f"<li>{_inline(item)}</li>")
        elif raw.startswith(">"):
            flush_para()
            close_list()
            quoted = html.escape(raw[1:].strip(), quote=False)
            out.append(f"<blockquote>{_inline(quoted)}</blockquote>")
        elif re.match(r"^(---|\*\*\*)\s*$", raw):
            flush_para()
            close_list()
            out.append("<hr>")
        elif not raw.strip():
            flush_para()
            close_list()
        elif in_list:
            # wrapped continuation of the previous bullet: merge into
            # its <li> — flushing it as a <p> inside the open list would
            # split every multi-line bullet
            out[-1] = out[-1][:-5] + " " + _inline(line.strip()) + "</li>"
        else:
            para.append(line)
        i += 1

    flush_para()
    close_list()
    return "\n".join(out)


def _shell(title: str, body: str) -> str:
    return (
        "<!doctype html><html><head><meta charset=\"utf-8\">"
        f"<title>{html.escape(title)} · ucfp-tpu docs</title>"
        f"<style>{_STYLE}</style></head><body>"
        "<header><h1>ucfp-tpu docs</h1>"
        '<a href="/docs">index</a> <a href="/">playground</a></header>'
        f"<main>{body}</main></body></html>"
    )


def list_pages() -> list[tuple[str, str]]:
    """(name, title) pairs: curated order first, stray files appended."""
    known = [name for name, _ in _ORDER]
    pages = [(n, t) for n, t in _ORDER if (DOCS_DIR / f"{n}.md").exists()]
    if DOCS_DIR.is_dir():
        for p in sorted(DOCS_DIR.glob("*.md")):
            if p.stem not in known:
                pages.append((p.stem, p.stem.replace("-", " ")))
    return pages


def index_html() -> str:
    items = "".join(
        f'<a href="/docs/{name}">{html.escape(title)}</a>'
        for name, title in list_pages()
    )
    return _shell("Documentation", f"<h1>Documentation</h1><div class=\"toc\">{items}</div>")


_TITLES = dict(_ORDER)


def page_html(name: str) -> Optional[str]:
    """Rendered page, or None when the name is invalid or absent."""
    if not _NAME_RE.match(name):
        return None
    path = DOCS_DIR / f"{name}.md"
    if not path.is_file():
        return None
    return _shell(_TITLES.get(name, name), render_markdown(path.read_text()))
