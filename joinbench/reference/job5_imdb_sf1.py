"""The plain reference of job5_imdb_sf1: each document's WHERE clause
applied to the generated tables in NumPy and its join conditions in plain
PyTorch (joinbench/relops.py), written from the SQL text. Its output is
the SELECT list's columns over every joined row (the rows the MIN()
aggregates would read), as the program returns them."""

from joinbench.relops import Table, between, compare, eq, isin, join, like, scan

_CODES = [b"A5362", b"B6526", b"C4321", b"D1500", b"E2630", b"F6523",
          b"G6253", b"H4163"]


def _not_like(col, pattern):
    return col.valid & ~like(col, pattern)


def result(name: str, tables, device):
    """Document ``name``'s result as a relation and the names of its
    output columns, in SELECT order."""
    t = {n: Table(n, h) for n, h in tables.items()}
    if name == "q1a":
        note = t["movie_companies"].col("note")
        mc_mask = (_not_like(note, b"%(as Metro-Goldwyn-Mayer Pictures)%")
                   & (like(note, b"%(co-production)%")
                      | like(note, b"%(presents)%")))
        ct = scan(t["company_type"], "ct", ["id"],
                  eq(t["company_type"].col("kind"), b"production companies"),
                  device)
        it = scan(t["info_type"], "it", ["id"],
                  isin(t["info_type"].col("info"),
                       [b"top 250 rank", b"bottom 10 rank"]), device)
        mc = scan(t["movie_companies"], "mc",
                  ["movie_id", "company_type_id", "note"], mc_mask, device)
        mi = scan(t["movie_info_idx"], "mi", ["movie_id", "info_type_id"],
                  None, device)
        ti = scan(t["title"], "t", ["id", "title", "production_year"], None,
                  device)
        r = join(join(join(join(ct, mc, "ct.id", "mc.company_type_id"), ti,
                           "mc.movie_id", "t.id"),
                      mi, "t.id", "mi.movie_id"),
                 it, "mi.info_type_id", "it.id")
        return r, ["mc.note", "t.title", "t.production_year"]
    if name == "q_or":
        kw = t["keyword"].col("keyword")
        year = t["title"].col("production_year")
        k = scan(t["keyword"], "k", ["id", "keyword"],
                 like(kw, b"%sequel%") | isin(kw, [b"murder", b"revenge"]),
                 device)
        ti = scan(t["title"], "t", ["id", "title"],
                  compare(year, ">", 2005) | compare(year, "<", 1950), device)
        mk = scan(t["movie_keyword"], "mk", ["movie_id", "keyword_id"], None,
                  device)
        r = join(join(mk, k, "mk.keyword_id", "k.id"), ti, "mk.movie_id",
                 "t.id")
        return r, ["k.keyword", "t.title"]
    if name == "q_alias":
        lt = scan(t["link_type"], "lt", ["id", "link"],
                  isin(t["link_type"].col("link"),
                       [b"sequel", b"follows", b"followed by"]), device)
        ml = scan(t["movie_link"], "ml",
                  ["movie_id", "linked_movie_id", "link_type_id"], None, device)
        t1 = scan(t["title"], "t1", ["id", "title"], None, device)
        t2 = scan(t["title"], "t2", ["id", "title"],
                  between(t["title"].col("production_year"), 2000, 2010),
                  device)
        r = join(join(join(ml, lt, "ml.link_type_id", "lt.id"), t2,
                      "ml.linked_movie_id", "t2.id"),
                 t1, "ml.movie_id", "t1.id")
        return r, ["lt.link", "t1.title", "t2.title"]
    if name == "q_varchar":
        cn_t = t["company_name"]
        cn = scan(cn_t, "cn", ["id", "name", "name_pcode_sf"],
                  isin(cn_t.col("name_pcode_sf"), _CODES)
                  & eq(cn_t.col("country_code"), b"[us]"), device)
        k = scan(t["keyword"], "k", ["keyword", "phonetic_code"],
                 isin(t["keyword"].col("phonetic_code"), _CODES), device)
        mc = scan(t["movie_companies"], "mc", ["company_id", "note"],
                  like(t["movie_companies"].col("note"), b"%(USA)%"), device)
        r = join(mc, join(cn, k, "cn.name_pcode_sf", "k.phonetic_code"),
                 "mc.company_id", "cn.id")
        return r, ["cn.name", "k.keyword", "mc.note"]
    if name == "q6a":
        k = scan(t["keyword"], "k", ["id", "keyword"],
                 eq(t["keyword"].col("keyword"), b"marvel-cinematic-universe"),
                 device)
        n = scan(t["name"], "n", ["id", "name"],
                 like(t["name"].col("name"), b"%Downey%Robert%"), device)
        ti = scan(t["title"], "t", ["id", "title"],
                  compare(t["title"].col("production_year"), ">", 2010), device)
        mk = scan(t["movie_keyword"], "mk", ["movie_id", "keyword_id"], None,
                  device)
        ci = scan(t["cast_info"], "ci", ["movie_id", "person_id"], None, device)
        r = join(join(join(join(mk, k, "mk.keyword_id", "k.id"), ti,
                           "mk.movie_id", "t.id"),
                      ci, "t.id", "ci.movie_id"),
                 n, "ci.person_id", "n.id")
        return r, ["k.keyword", "n.name", "t.title"]
    raise KeyError(name)
