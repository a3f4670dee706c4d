"""The paper's criteria, aggregation operators and Eq. 3 weights."""
