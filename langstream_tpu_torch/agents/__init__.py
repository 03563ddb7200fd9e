"""The port's agent-side data services: the datasource SPI and the
vector store on the card."""
