"""The port's agents and agent-side data services: ``document-to-json``
and the text agents (``text.py``), the GenAI toolkit (``genai.py``) with
its expression language (``el.py``) and record view (``transform.py``),
the datasource SPI and the vector store on the card, the vector agents,
``re-rank`` and FLARE; the flow agents (``flow.py``), the python agents
(``python_agents.py``, crash-isolated by ``isolation.py``), the network
agents on one HTTP client (``http_client.py``: ``http_request.py``,
``storage.py``, ``azure_blob.py``, ``webcrawler.py``), the exec
connector (``connector.py``), ``camel-source`` (``camel.py``) and Kafka
Connect's source and sink (``kafka_connect.py``)."""
