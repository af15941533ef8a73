"""One module per kind of configuration (its `kind` key): how its catalog
and its requests are made from the seed, how requests are written and
answers read, and the least work of one call of the index layer."""
