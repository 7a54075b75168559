"""The generators of the traffic mixes, one module a kind of work; a mix file names its own."""
