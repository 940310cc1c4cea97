"""A deterministic enwik-like MediaWiki dump, the input of the sweeps' wiki
chain and ring sweep (`gmix_tpu_torch/sweeps.py`).

The port's copy of `tools/make_wiki_corpus.py`'s generator (`load_words`,
`Gen`, `make_corpus`): the same `random.Random` calls in the same order, so
`make_corpus(size, seed)` gives the tool's bytes for any size and seed. The
words come from the port's `gmix_tpu_torch/assets/english.dic`, the file the
dictionary transform reads (so dict-encode sees realistic hit rates).

A dump has a <mediawiki>/<siteinfo> intro, <page> headers with increasing
ids, revision ids, ISO timestamps, ip or user contributors, <minor/>,
<comment>, about 8% #REDIRECT pages, article text with entity-encoded
markup, numeric entities, raw UTF-8, links, sections, lists, templates,
categories and inter-language links, Zipf-distributed English words, and a
page truncated mid-way at its end (enwik9 ends mid-page).
"""
import datetime
import os
import random

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")

INTRO = (
    '<mediawiki xmlns="http://www.mediawiki.org/xml/export-0.3/" '
    'xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance" '
    'xsi:schemaLocation="http://www.mediawiki.org/xml/export-0.3/ '
    'http://www.mediawiki.org/xml/export-0.3.xsd" version="0.3" '
    'xml:lang="en">\n'
    "  <siteinfo>\n"
    "    <sitename>Wikipedia</sitename>\n"
    "    <base>http://en.wikipedia.org/wiki/Main_Page</base>\n"
    "    <generator>MediaWiki 1.6alpha</generator>\n"
    "    <case>first-letter</case>\n"
    "      <namespaces>\n"
    '      <namespace key="0" />\n'
    '      <namespace key="1">Talk</namespace>\n'
    "    </namespaces>\n"
    "  </siteinfo>\n"
)

LANGS = ["de", "fr", "es", "ja", "pl", "nl", "it", "sv", "pt", "zh-min-nan",
         "eo", "da", "he", "fi", "no", "ru"]
UNICODE_SNIPPETS = ["é", "ü", "π", "—", "°",
                    "è", "中文", "ß", "ğ"]


def load_words():
    """The alphabetic words of english.dic, in its (frequency) order."""
    words = []
    with open(os.path.join(ASSET_DIR, "english.dic"), "rb") as f:
        for line in f:
            w = line.strip().decode("latin-1")
            if w and w.isalpha():
                words.append(w)
    return words


class Gen:
    def __init__(self, seed, words):
        self.rng = random.Random(seed)
        self.words = words
        self.n = len(words)

    def word(self):
        # Zipf-ish: the dictionary is frequency-ordered, so a skewed index
        # distribution reproduces natural-language word statistics
        r = self.rng.random()
        ix = int(self.n * (r ** 3.5))
        return self.words[min(ix, self.n - 1)]

    def phrase(self, lo, hi):
        return " ".join(self.word() for _ in range(self.rng.randint(lo, hi)))

    def sentence(self):
        rng = self.rng
        parts = []
        nw = rng.randint(6, 22)
        for i in range(nw):
            w = self.word()
            r = rng.random()
            if r < 0.035:
                w = f"[[{w}]]"
            elif r < 0.045:
                w = f"[[{self.word()}|{w}]]"
            elif r < 0.052:
                w = f"'''{w}'''"
            elif r < 0.058:
                w = f"''{w}''"
            elif r < 0.062:
                w = f"&quot;{w}&quot;"
            elif r < 0.064:
                w = w + rng.choice(UNICODE_SNIPPETS)
            elif r < 0.066:
                w = f"&#{rng.choice([960, 8212, 945, 233, 176])};"
            elif r < 0.068:
                w = f"{rng.randint(1, 2000)}"
            parts.append(w)
        s = " ".join(parts)
        s = s[0].upper() + s[1:]
        return s + rng.choice([". ", ". ", ". ", "? ", "! "])

    def paragraph(self):
        return "".join(self.sentence() for _ in range(self.rng.randint(2, 7))).rstrip()

    def body(self):
        rng = self.rng
        out = []
        npar = rng.randint(1, 8)
        for p in range(npar):
            if p > 0 and rng.random() < 0.4:
                out.append(f"== {self.phrase(1, 3).title()} ==")
            if rng.random() < 0.15:
                for _ in range(rng.randint(2, 5)):
                    out.append(f"* {self.sentence().strip()}")
            out.append(self.paragraph())
            out.append("")
            if rng.random() < 0.08:
                out.append(
                    f"{{{{{rng.choice(['stub', 'cleanup', 'main', 'see also'])}}}}}"
                )
            if rng.random() < 0.1:
                out.append(
                    "Reference: &lt;ref&gt;" + self.phrase(3, 6)
                    + "&lt;/ref&gt; and [http://www."
                    + self.word() + ".org/" + self.word() + " external]."
                )
        if rng.random() < 0.5:
            for _ in range(rng.randint(1, 3)):
                out.append(f"[[Category:{self.phrase(1, 2).title()}]]")
        if rng.random() < 0.45:
            for lang in sorted(rng.sample(LANGS, rng.randint(1, 5))):
                out.append(f"[[{lang}:{self.phrase(1, 2).title()}]]")
        return [ln for ln in out]


def make_corpus(size, seed=20260821):
    """The dump that `seed` makes: whole pages until `size` bytes are
    reached, then the truncated page, cut at `size` plus the length of that
    page's text."""
    words = load_words()
    g = Gen(seed, words)
    rng = g.rng
    chunks = [INTRO]
    total = len(INTRO)
    pid = 0
    rev = 1000
    ts = 1076000000  # ~2004-02
    titles_seen = set()

    while total < size:
        pid += rng.randint(1, 6)
        rev += rng.randint(1, 4000)
        ts += rng.randint(1, 400000)
        t = datetime.datetime.fromtimestamp(ts, datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
        title = g.phrase(1, 3).title()
        if title in titles_seen:
            title += f" ({g.word()})"
        titles_seen.add(title)
        lines = ["  <page>", f"    <title>{title}</title>", f"    <id>{pid}</id>"]
        if rng.random() < 0.01:
            lines.append("    <restrictions>move=:edit=</restrictions>")
        lines += ["    <revision>", f"      <id>{rev}</id>",
                  f"      <timestamp>{t}</timestamp>", "      <contributor>"]
        if rng.random() < 0.2:
            ip = ".".join(str(rng.randint(1, 254)) for _ in range(4))
            lines.append(f"        <ip>{ip}</ip>")
        else:
            lines.append(f"        <username>{g.word().title()}{rng.randint(1, 99)}</username>")
            lines.append(f"        <id>{rng.randint(100, 99999)}</id>")
        lines.append("      </contributor>")
        if rng.random() < 0.25:
            lines.append("      <minor />")
        if rng.random() < 0.35:
            lines.append(f"      <comment>{g.phrase(2, 8)}</comment>")
        if rng.random() < 0.08:
            body = [f"#REDIRECT [[{g.phrase(1, 3).title()}]]"]
        else:
            body = g.body()
        first = body[0] if body else ""
        text = [f'      <text xml:space="preserve">{first}'] + body[1:]
        text[-1] = text[-1] + "</text>"
        lines += text + ["    </revision>", "  </page>"]
        page = "\n".join(lines) + "\n"
        chunks.append(page)
        total += len(page.encode("utf-8"))
    # coda: a page truncated mid-way (enwik9 ends mid-page; misc.h:9-61)
    coda = "  <page>\n    <title>Truncated article cut mid-"
    chunks.append(coda)
    return "".join(chunks).encode("utf-8")[: size + len(coda.encode())]
