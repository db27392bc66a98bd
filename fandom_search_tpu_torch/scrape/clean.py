"""Loading a works directory; counterpart of fandom_search_tpu/scrape/clean.py:19-158.

``load_works_dir`` and the helpers it calls, copied so that the port
imports nothing of the JAX package.  bs4 stays a lazy import: it is
needed only for ``.html`` works.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional


def _bs4_parser() -> str:
    """lxml when available (faster than the pure-Python html.parser,
    identical extraction for AO3's well-formed pages), else the stdlib
    parser."""
    try:
        import lxml  # noqa: F401

        return "lxml"
    except ImportError:
        return "html.parser"


def extract_text(html: str) -> Optional[str]:
    """Story text from an AO3 work page, or None if the page is broken.

    Strips AO3 chrome: preface, summary/notes modules, chapter landmark
    headings — keeping only userstuff paragraphs inside #workskin.
    """
    from bs4 import BeautifulSoup

    soup = BeautifulSoup(html, _bs4_parser())
    skin = soup.select_one("#workskin")
    if skin is None:
        return None
    for sel in ("div.preface", "div.summary", "div.notes", "h3.landmark",
                "h3.title", "div.fff_chapter_notes"):
        for node in skin.select(sel):
            node.decompose()
    chunks: List[str] = []
    userstuff = skin.select("div.userstuff")
    if not userstuff:
        userstuff = [skin]
    for us in userstuff:
        text = us.get_text(separator="\n")
        text = "\n".join(s.strip() for s in text.splitlines() if s.strip())
        if text:
            chunks.append(text)
    return "\n\n".join(chunks) if chunks else None


def load_works_dir(path: Path) -> Dict[str, str]:
    """{work_id: text} from a dir of .txt (cleaned) and/or .html works."""
    works: Dict[str, str] = {}
    p = Path(path)
    for f in sorted(p.glob("*.txt")):
        works[f.stem] = f.read_text(encoding="utf-8", errors="replace")
    for f in sorted(p.glob("*.html")):
        if f.stem in works:
            continue
        text = extract_text(f.read_text(encoding="utf-8", errors="replace"))
        if text:
            works[f.stem] = text
    return works
