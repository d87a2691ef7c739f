"""The general traffic generators, one a kind of traffic; a cell's
``traffic/<name>.json`` names one as ``driver`` and gives its
parameters."""
