"""Signature policies (reference common/cauthdsl + common/policydsl): the
datamodel and DSL, the proto conversion, the host evaluators and K7, the
batched policy circuit on the card."""
