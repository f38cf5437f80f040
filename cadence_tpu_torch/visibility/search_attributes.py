"""Search attribute vocabulary.

Reference: the system search attributes the frontend advertises via
GetSearchAttributes (service/frontend/workflowHandler.go) and the
default custom keys seeded by schema/elasticsearch.

A copy of the reference package's ``visibility/search_attributes.py``.
"""

DEFAULT_SEARCH_ATTRIBUTES = {
    # system attributes
    "DomainID": "KEYWORD",
    "WorkflowID": "KEYWORD",
    "RunID": "KEYWORD",
    "WorkflowType": "KEYWORD",
    "StartTime": "INT",
    "ExecutionTime": "INT",
    "CloseTime": "INT",
    "CloseStatus": "INT",
    "HistoryLength": "INT",
    # seeded custom attributes (schema/elasticsearch visibility index)
    "CustomKeywordField": "KEYWORD",
    "CustomStringField": "STRING",
    "CustomIntField": "INT",
    "CustomDoubleField": "DOUBLE",
    "CustomBoolField": "BOOL",
    "CustomDatetimeField": "DATETIME",
    "CustomDomain": "KEYWORD",
    "Operator": "KEYWORD",
}

SYSTEM_ATTRIBUTES = frozenset(
    {
        "DomainID",
        "WorkflowID",
        "RunID",
        "WorkflowType",
        "StartTime",
        "ExecutionTime",
        "CloseTime",
        "CloseStatus",
        "HistoryLength",
    }
)
