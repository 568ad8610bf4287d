"""How each configuration's data is drawn.

`portbench/recipes/<recipe>.py` holds `intents(data, seed)`, which
draws the configuration's `data` from the seed (a `gen.Intents`), and
`queries(data, query, r, m)`, which draws `m` queries of a traffic
mix's `query` recipe with the generator `r` (a `gen.Queries`).
"""
