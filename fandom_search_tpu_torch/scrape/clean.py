"""HTML cleaning and metadata extraction; counterpart of fandom_search_tpu/scrape/clean.py.

Turns scraped AO3 work pages into (a) plain story text ready for
tokenization and (b) a metadata CSV (title, author, tags, kudos, ...):
the ``clean`` and ``getmeta`` verbs.  Truncated or error downloads (no
``#workskin`` body) are detected and dropped.  ``load_works_dir`` reads
a works directory for ``search``.  A copy, so that the port imports
nothing of the JAX package; bs4 (and lxml, where present) stays a lazy
import, needed only for ``.html`` pages.
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path
from typing import Dict, List, Optional

log = logging.getLogger(__name__)


def _bs4_parser() -> str:
    """lxml when available (~5-10x faster than the pure-Python
    html.parser at corpus scale; identical extraction for AO3's
    well-formed pages), else the stdlib fallback."""
    try:
        import lxml  # noqa: F401

        return "lxml"
    except ImportError:
        return "html.parser"

META_FIELDS = (
    "work_id",
    "title",
    "author",
    "rating",
    "fandoms",
    "relationships",
    "characters",
    "additional_tags",
    "language",
    "published",
    "words",
    "chapters",
    "kudos",
    "comments",
    "bookmarks",
    "hits",
)


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


def _sel_text(soup, sel: str) -> str:
    node = soup.select_one(sel)
    return node.get_text(strip=True) if node else ""


def _sel_join(soup, sel: str) -> str:
    return "; ".join(a.get_text(strip=True) for a in soup.select(sel))


def extract_meta(html: str, work_id: str = "") -> Optional[Dict[str, str]]:
    """Work metadata from the page preface + stats block."""
    from bs4 import BeautifulSoup

    soup = BeautifulSoup(html, _bs4_parser())
    if soup.select_one("#workskin") is None:
        return None
    meta = {k: "" for k in META_FIELDS}
    meta["work_id"] = work_id
    meta["title"] = _sel_text(soup, "#workskin h2.title")
    meta["author"] = _sel_join(soup, "#workskin h3.byline a")
    meta["rating"] = _sel_join(soup, "dd.rating a.tag")
    meta["fandoms"] = _sel_join(soup, "dd.fandom a.tag")
    meta["relationships"] = _sel_join(soup, "dd.relationship a.tag")
    meta["characters"] = _sel_join(soup, "dd.character a.tag")
    meta["additional_tags"] = _sel_join(soup, "dd.freeform a.tag")
    meta["language"] = _sel_text(soup, "dd.language")
    meta["published"] = _sel_text(soup, "dd.published")
    for stat in ("words", "chapters", "kudos", "comments", "bookmarks", "hits"):
        meta[stat] = _sel_text(soup, f"dd.{stat}")
    return meta


def clean_corpus(
    src_dir: Path,
    out_dir: Path,
    *,
    min_words: int = 10,
) -> List[str]:
    """Extract text for every .html work; returns kept work ids."""
    out_dir.mkdir(parents=True, exist_ok=True)
    kept = []
    for f in sorted(Path(src_dir).glob("*.html")):
        text = extract_text(f.read_text(encoding="utf-8", errors="replace"))
        if text is None or len(text.split()) < min_words:
            log.info("dropping %s (broken or too short)", f.name)
            continue
        (out_dir / (f.stem + ".txt")).write_text(text, encoding="utf-8")
        kept.append(f.stem)
    return kept


def write_metadata_csv(src_dir: Path, out_csv: Path) -> int:
    """Extract metadata for every .html work into one CSV; returns count."""
    out_csv.parent.mkdir(parents=True, exist_ok=True)
    n = 0
    with out_csv.open("w", newline="", encoding="utf-8") as fh:
        w = csv.DictWriter(fh, fieldnames=list(META_FIELDS))
        w.writeheader()
        for f in sorted(Path(src_dir).glob("*.html")):
            meta = extract_meta(
                f.read_text(encoding="utf-8", errors="replace"), work_id=f.stem
            )
            if meta:
                w.writerow(meta)
                n += 1
    return n


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
