"""Advanced visibility: query language + store + sampling.

Reference: common/persistence/elasticsearch/esVisibilityStore.go (the
advanced store) + common/elasticsearch/esql/ (SQL → ES-DSL translation)
+ common/persistence/visibilitySamplingClient.go. This package keeps
visibility host-side: records live in the pluggable visibility manager
and the query language compiles to a Python predicate + sort instead of
an ES DSL — same operators, same attribute vocabulary.

A copy of the reference package's ``visibility/__init__.py``.
"""

from .query import QueryError, VisibilityQuery, compile_query
from .advanced import AdvancedVisibilityStore
from .sampling import SamplingVisibilityClient
from .search_attributes import DEFAULT_SEARCH_ATTRIBUTES

__all__ = [
    "QueryError",
    "VisibilityQuery",
    "compile_query",
    "AdvancedVisibilityStore",
    "SamplingVisibilityClient",
    "DEFAULT_SEARCH_ATTRIBUTES",
]
