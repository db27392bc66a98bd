"""The port's scraper and cleaner (``scrape``, ``clean``, ``getmeta``) against the JAX package.

Tolerance: 0.  Extracted text, metadata, work ids, URLs and retry waits
compare with ==; the files that ``clean_corpus``, ``write_metadata_csv``
and ``scrape_tag`` write, and the CLI verbs' outputs, compare byte for
byte.  Pages are tests/fixtures.py's (no real scraped content) and the
cases are tests/test_scrape_clean.py's; every fetch is a fake, so
nothing touches the network.
"""

import dataclasses
from pathlib import Path

import pytest

from fandom_search_tpu import cli as jcli
from fandom_search_tpu.scrape import ao3 as jao3
from fandom_search_tpu.scrape import clean as jclean
from fandom_search_tpu_torch import cli
from fandom_search_tpu_torch.scrape import ao3, clean
from fixtures import broken_page, listing_page, work_page

PAGES = {
    "work": work_page("1", "My Title", "auth", ["First para.", "Second para."]),
    "meta": work_page("7", "T", "alice_fan", ["one two three"], kudos=3),
    "unicode": work_page("9", "Naïve — café", "zoë", ["Straße  über\tline", "", "x" * 40]),
    "broken": broken_page(),
    "listing": listing_page(["11", "22"]),
    # a workskin without userstuff: the whole skin is the text
    "bare": '<html><body><div id="workskin"><p>Only</p><p>text here.</p></div></body></html>',
    # a workskin whose text is all chrome: no chunks
    "chrome": ('<html><body><div id="workskin"><div class="preface">P</div>'
               '<div class="userstuff">  </div></div></body></html>'),
}


@pytest.mark.parametrize("name", sorted(PAGES))
def test_extract_text_and_meta_match(name):
    html = PAGES[name]
    assert clean.extract_text(html) == jclean.extract_text(html)
    assert clean.extract_meta(html, work_id=name) == jclean.extract_meta(html, work_id=name)
    if name == "meta":
        meta = clean.extract_meta(html, work_id="7")
        assert (meta["author"], meta["characters"], meta["kudos"]) == ("alice_fan",
                                                                     "Alice; Bob", "3")
    assert clean.META_FIELDS == jclean.META_FIELDS


@pytest.mark.parametrize("html", [
    listing_page(["11", "22", "33"]),
    listing_page([]),
    # markup drift: no li.work, only /works/<id> links (duplicates once)
    '<html><a href="/works/5">a</a><a href="/works/5">b</a><a href="/users/x">u</a>'
    '<a href="/works/6">c</a></html>',
])
def test_parse_work_ids_match(html):
    assert ao3.parse_work_ids(html) == jao3.parse_work_ids(html)


@pytest.mark.parametrize("tag,page", [("My Tag", 2), ("Harry Potter/Draco", 1), ("a&b?c", 10)])
def test_urls_match(tag, page):
    assert ao3.tag_search_url(tag, page) == jao3.tag_search_url(tag, page)
    assert ao3.work_url(tag) == jao3.work_url(tag)
    assert ao3.AO3_BASE == jao3.AO3_BASE


@pytest.mark.parametrize("value", ["120", "0", "-5", "2.5", "Wed, 21 Oct 2015 07:28:00 GMT",
                                   "not a date"])
def test_parse_retry_after_matches(value):
    assert ao3._parse_retry_after(value) == jao3._parse_retry_after(value)


def test_scrape_config_and_rate_limited_match():
    assert [(f.name, f.default) for f in dataclasses.fields(ao3.ScrapeConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(jao3.ScrapeConfig)]
    e, je = ao3.RateLimited(7.0), jao3.RateLimited(7.0)
    assert (str(e), e.retry_after) == (str(je), je.retry_after)


class _Resp:
    def __init__(self, status, text="", headers=None):
        self.status_code, self.text, self.headers = status, text, headers or {}

    def raise_for_status(self):
        if self.status_code >= 400:
            raise RuntimeError(f"HTTP {self.status_code}")


@pytest.mark.parametrize("status,headers", [(200, {}), (429, {"Retry-After": "30"}),
                                            (429, {}), (500, {})])
def test_default_fetch_matches_on_a_fake_requests(monkeypatch, status, headers):
    """default_fetch's handling of a response (text, 429 with or without
    Retry-After, an error status) with requests.get replaced by a fake."""
    import requests

    calls = []

    def get(url, headers, timeout):
        calls.append((url, headers, timeout))
        return _Resp(status, "<html>ok</html>", headers_)

    headers_ = headers
    monkeypatch.setattr(requests, "get", get)
    out = []
    for mod in (ao3, jao3):
        try:
            out.append(("text", mod.default_fetch("https://example.invalid/x")))
        except mod.RateLimited as e:
            out.append(("rate", e.retry_after))
        except RuntimeError as e:
            out.append(("error", str(e)))
    assert out[0] == out[1] and calls[0] == calls[1]


def _html_files(d: Path):
    return {f.name: f.read_bytes() for f in sorted(d.iterdir())}


@pytest.fixture
def raw(tmp_path):
    src = tmp_path / "raw"
    src.mkdir()
    (src / "1.html").write_text(work_page("1", "A", "x", ["word " * 30]), encoding="utf-8")
    (src / "2.html").write_text(broken_page(), encoding="utf-8")
    (src / "3.html").write_text(work_page("3", "B", "y", ["too short"]), encoding="utf-8")
    (src / "4.html").write_text(work_page("4", "Cé", "zoë", ["Straße " * 12, "two"]),
                                encoding="utf-8")
    (src / "5.html").write_bytes(work_page("5", "D", "w", ["bad \xff " * 9]).encode("latin-1"))
    (src / "notes.txt").write_text("not a page", encoding="utf-8")
    return src


@pytest.mark.parametrize("min_words", [10, 1])
def test_clean_corpus_writes_the_same_files(tmp_path, raw, min_words):
    kept = clean.clean_corpus(raw, tmp_path / "p", min_words=min_words)
    jkept = jclean.clean_corpus(raw, tmp_path / "j", min_words=min_words)
    assert kept == jkept and kept[0] == "1"
    assert _html_files(tmp_path / "p") == _html_files(tmp_path / "j")
    assert clean.load_works_dir(tmp_path / "p") == jclean.load_works_dir(tmp_path / "j")


def test_write_metadata_csv_writes_the_same_bytes(tmp_path, raw):
    n = clean.write_metadata_csv(raw, tmp_path / "p" / "meta.csv")
    jn = jclean.write_metadata_csv(raw, tmp_path / "j" / "meta.csv")
    assert n == jn == 4
    assert (tmp_path / "p" / "meta.csv").read_bytes() == (tmp_path / "j" / "meta.csv").read_bytes()


def _fake_site(pages, fail=(), limited=()):
    """A fetch over fixture pages: listing ``page`` -> its work ids; work
    ids in ``fail`` raise; those in ``limited`` answer 429 once (with the
    module's own RateLimited, which only its own retry loop catches)."""
    def make(mod):
        fetched, hit = [], set()

        def fetch(url):
            fetched.append(url)
            if "/tags/" in url:
                return listing_page(pages.get(int(url.rsplit("page=", 1)[1]), []))
            wid = url.split("/works/")[1].split("?")[0]
            if wid in fail:
                raise RuntimeError("boom")
            if wid in limited and wid not in hit:
                hit.add(wid)
                raise mod.RateLimited(90.0)
            return work_page(wid, f"W{wid}", "a", ["text " * 20])
        return fetch, fetched
    return make


def _scrape(mod, out: Path, site, **cfg):
    fetch, fetched = site(mod)
    sleeps = []
    got = list(mod.scrape_tag(mod.ScrapeConfig(tag="t", out_dir=out, **cfg), fetch=fetch,
                              sleep=sleeps.append))
    return [p.name for p in got], fetched, sleeps


@pytest.mark.parametrize("case", ["resumable", "failed_work", "rate_limited", "end_page"])
def test_scrape_tag_matches_with_a_fake_fetch(tmp_path, case):
    """The same files, yields, fetches and sleeps as the JAX scraper: a
    second run downloads nothing and refetches only listings; a failed
    work is skipped; a 429 waits max(Retry-After, backoff) and retries;
    end_page stops early."""
    site = {"resumable": _fake_site({1: ["101", "102"], 2: ["103"]}),
            "failed_work": _fake_site({1: ["201", "202"]}, fail={"201"}),
            "rate_limited": _fake_site({1: ["301", "302"]}, limited={"302"}),
            "end_page": _fake_site({1: ["401"], 2: ["402"], 3: ["403"]})}[case]
    cfg = dict(delay_seconds=0.5, max_retries=2 if case != "failed_work" else 1,
               backoff_seconds=60.0, end_page=2 if case == "end_page" else None)
    got = _scrape(ao3, tmp_path / "p", site, **cfg)
    want = _scrape(jao3, tmp_path / "j", site, **cfg)
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]
    assert _html_files(tmp_path / "p") == _html_files(tmp_path / "j")
    names = {"resumable": ["101.html", "102.html", "103.html"],
             "failed_work": ["202.html"], "rate_limited": ["301.html", "302.html"],
             "end_page": ["401.html", "402.html"]}[case]
    assert got[0] == names
    if case == "rate_limited":
        assert 90.0 in got[2]
    if case == "resumable":
        again = _scrape(ao3, tmp_path / "p", site, **cfg)
        assert again[0] == [] and all("/tags/" in u for u in again[1])


def test_cli_clean_and_getmeta_match_jax(tmp_path, raw, capsys):
    for verb, out in (("clean", "c"), ("getmeta", "m.csv")):
        assert cli.main([verb, str(raw), "-o", str(tmp_path / "p" / out)]) == 0
        perr = capsys.readouterr().err
        assert jcli.main([verb, str(raw), "-o", str(tmp_path / "j" / out)]) == 0
        assert perr == capsys.readouterr().err
    assert _html_files(tmp_path / "p" / "c") == _html_files(tmp_path / "j" / "c")
    assert (tmp_path / "p" / "m.csv").read_bytes() == (tmp_path / "j" / "m.csv").read_bytes()


def test_cli_scrape_matches_jax_on_a_fake_requests(tmp_path, monkeypatch, capsys):
    """`scrape TAG -o DIR --delay 0 --end-page 2` with requests.get
    replaced by a fake site: the same files and output as the JAX CLI."""
    import requests

    def get(url, headers, timeout):
        if "/tags/" in url:
            page = int(url.rsplit("page=", 1)[1])
            return _Resp(200, listing_page({1: ["11", "12"], 2: ["13"]}.get(page, [])))
        wid = url.split("/works/")[1].split("?")[0]
        return _Resp(200, work_page(wid, f"W{wid}", "a", ["text " * 20]))

    monkeypatch.setattr(requests, "get", get)
    outs = []
    for main, d in ((cli.main, "p"), (jcli.main, "j")):
        assert main(["scrape", "My Tag", "-o", str(tmp_path / d), "--delay", "0",
                     "--end-page", "2"]) == 0
        o = capsys.readouterr()
        outs.append((o.out.replace(str(tmp_path / d), "DIR"), o.err))
    assert outs[0] == outs[1] and "downloaded 3 works" in outs[0][1]
    assert _html_files(tmp_path / "p") == _html_files(tmp_path / "j")
