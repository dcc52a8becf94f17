"""The plain reference of joingraph_imdb_sf1: each plan's join graph over
the generated tables, in plain PyTorch (joinbench/relops.py), written from
the join conditions and not from the program's plans."""

from joinbench.relops import Table, join, scan


def result(name: str, tables, device):
    """Plan ``name``'s result as a relation and the names of its output
    columns, in their order."""
    t = {n: Table(n, h) for n, h in tables.items()}
    if name == "S1":
        ct = scan(t["company_type"], "ct", ["id", "kind"], None, device)
        mc = scan(t["movie_companies"], "mc", ["movie_id", "company_type_id"],
                  None, device)
        it = scan(t["info_type"], "it", ["id"], None, device)
        mi = scan(t["movie_info_idx"], "mi", ["movie_id", "info_type_id"], None,
                  device)
        ti = scan(t["title"], "t", ["id", "production_year"], None, device)
        r = join(join(it, mi, "it.id", "mi.info_type_id"),
                 join(ti, join(ct, mc, "ct.id", "mc.company_type_id"),
                      "t.id", "mc.movie_id"),
                 "mi.movie_id", "t.id")
        return r, ["mi.movie_id", "it.id", "t.production_year", "ct.kind"]
    if name == "S2":
        rt = scan(t["role_type"], "rt", ["id"], None, device)
        ci = scan(t["cast_info"], "ci", ["movie_id", "person_id", "role_id"],
                  None, device)
        mk = scan(t["movie_keyword"], "mk", ["movie_id", "keyword_id"], None,
                  device)
        r = join(mk, join(rt, ci, "rt.id", "ci.role_id"), "mk.movie_id",
                 "ci.movie_id")
        return r, ["mk.movie_id", "mk.keyword_id", "ci.person_id"]
    if name == "S3":
        ra = scan(t["role_type"], "ra", ["id"], None, device)
        ca = scan(t["cast_info"], "ca", ["id", "movie_id", "role_id"], None,
                  device)
        rb = scan(t["role_type"], "rb", ["id"], None, device)
        cb = scan(t["cast_info"], "cb",
                  ["id", "person_id", "person_role_id", "role_id"], None,
                  device)
        r = join(join(ra, ca, "ra.id", "ca.role_id"),
                 join(rb, cb, "rb.id", "cb.role_id"), "ca.id", "cb.id")
        return r, ["ca.id", "ca.movie_id", "cb.person_id",
                      "cb.person_role_id"]
    raise KeyError(name)
