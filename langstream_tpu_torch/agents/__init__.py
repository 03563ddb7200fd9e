"""The port's agents and agent-side data services: ``document-to-json``
(``text.py``), the GenAI toolkit (``genai.py``) with its expression
language (``el.py``) and record view (``transform.py``), the datasource
SPI and the vector store on the card."""
